#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``cullavo_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py               # kernels, the 7B serving and train paths, X-Decoder
                                        # eval, vl_test from a written 7B snapshot, the VL
                                        # zoo, the training loop, the matmul probe, X-Decoder
                                        # training and eval from a checkpoint, the VLP eval
                                        # and DaViT, serving over HTTP with adapters
    python3 chip_smoke.py --profile     # the same + a profiled run of each path
    python3 chip_smoke.py --par-calibrate   # phases 22a and 22b in one process and on
                                        # two ranks at three seeds, and two planted
                                        # faults: the readings PAR_TOL is set from
    python3 chip_smoke.py --par-calibrate sharded   # the same under MESH_FSDP 2 (and
                                        # MESH_TENSOR 2), one planted fault

Phases (each raises on failure, and the script exits non-zero):
  1. print the card's name and power limit (nvidia-smi); disable TF32.
  2. build the port's CUDA kernels from ``cullavo_tpu_torch/csrc``; print
     the ptxas report of every instantiation of the Hopper templates (the
     forward flash kernel: K1 / K13, K1-lse, K8, K8-lse; the fused
     weight-only linears: K6 and K11 at token tiles 16, 32, 64 and 1, 2, 4
     blocks per CTA, K3 at 16 to 256 with 1, 2; the decode bodies
     of K12, K4 and K5; K9 by dtype, head dim and body; K2 by vectors a
     thread and multiplier: registers, spills, wgmma warnings) and raise if
     one is missing or spills.
  3. compare each kernel with its plain PyTorch version on the card.  First
     K1 and K1-lse, the causal flash forward on TMA and wgmma
     (``csrc/flash_fwd_sm90.cu``): at T = 1, 64, 127, 128, 129 and 200 on
     strided head views of [B, T, H, d] and on contiguous tensors, with k/v
     expanded over heads, and at the greedy prefill's [2 | 7, 32, 648, 128],
     the train step's [8, 32, 1024, 128] and the loop's [8, 32, 1929, 128]:
     o within 1e-2 + 1e-2 |ref|, the f32 lse within 2e-3, K1-lse's o
     bit-equal to K1's and a second launch bit-equal to the first; timed at
     the last three shapes in turns with the library's causal
     ``scaled_dot_product_attention`` and K13 (the same kernel behind its
     own maps) on the same bytes.  Then the kernels of the LLaVA-1.5-7B int8 VQA paths at
     their shapes (K2 row quantizer: codes and sx bit-equal at the greedy
     batch's [4536, 4096] and [4536, 11008], timed there card alone, and at
     its edges: one row of 16, K = 24576, M = 4537, no or an f32
     multiplier; K3 int8 weight-only linear at M = 8,
     14, 56 and 5632 with and without sq_inv beside the dense bf16 matmul
     on the dequantized weight, K4/K5
     W-window decode attention over the stacked bf16/int8 KV cache; also the
     library s8s8 GEMM): time kernel and plain version with CUDA events (L2 flushed before every launch), time the one
     PyTorch call that computes the same function where there is one, and
     work out each kernel's bound (bytes over 3.35 TB/s against operations
     over the card's peak rate) from the inputs of this run.  K4/K5 are held
     at the decode windows (W = 1 and 4, B = 14) and at the serving engine's
     suffix prefills (W = 32, 64 and 128, B = 4, cache gated to a 608-token
     prefix), both also at their edges (batch 1 at S = 4000 with a wholly
     masked range of 500 slots, S = 40, GQA); K4 and its library yardstick
     timed in turns, K5 with K4 on the bf16 cache and sdpa on the
     dequantized slice, the card kept busy ahead of each timed call.  Then the planar
     NF4 kernels at the three 7B weight shapes: K7 (dequant to dense bf16)
     bit-equal to its plain version, K6 (fused dequant-matmul, the Hopper
     template of csrc/nf4_gemv_sm90.cu) at M = 1, 14, 64, 256 and 511
     within 1e-2 + 1e-2 |ref|, timed at the serving decode M = 64 beside
     the dense bf16 matmul, the card kept busy ahead of each timed call.  Then the training kernels: K8
     (the masked flash forward with explicit positions and
     key validity, on K1's kernel) at the probe shape [6, 32, 648, 128] with
     right padding, with left padding (wholly masked rows: the mean of v),
     with S > T and non-causal, its o-only form bit-equal to its lse form,
     timed in turns with the library's sdpa (boolean mask) and K1-lse on the
     same bytes; the
     autograd function's dq, dk, dv against autograd through the plain
     version (within 2e-2 of the largest entry) and its chunked backward
     timed at the train shape; ``nf4_linear_planar_vjp``'s dx against the
     dense matmul at M = 8192.  Then the X-Decoder kernels: K9
     (multi-scale deformable attention) at the deformable encoder's shape
     at a 512² image (value [8, 5376, 8, 64], 3 levels x 4 points), at
     the 512 x 640 bucket's non-square levels and at a ragged Q, points
     partly outside the maps; K10 (the gated focal-modulation context) at
     each FocalNet-L stage map of the 512² and 512 x 640 buckets and of the
     VLP eval's 224² (56², 28², 14², 7²: the last under the 9 x 9 level),
     batch 8;
     both in bf16 (within 1e-2 + 1e-2 |ref|) and f32 (within 1e-5 + 1e-5
     |ref|), K10 with both GELU forms; timed beside a yardstick (K9: one
     ``grid_sample`` per level, the reference's composition; K10: the cuDNN
     depthwise ``conv2d`` chain in bf16, the model's own), K10 per stage with
     the card kept busy ahead of each timed call (host us apart) and summed
     over one forward, at 512² and at 224².  Then
     K11, the byte-packed NF4 kernel, at the three 7B weight shapes: its
     dequant entry bit-equal to ``dequant_linear``, its fused entry (the
     same template as K6) at M = 1, 14, 64, 129 and 511 within 1e-2 + 1e-2
     |ref| of the f32 plain version, and as row 8 (an NF4Tensor with its
     absmax decoded on the card) against ``dequantize_nf4`` + the product;
     timed at M = 14 and 64 beside the bound and the dense bf16 matmul on
     the dequantized weight, the card kept busy ahead of each timed call.  Then K12,
     the one-token decode attention, through ``flash_decode`` at the 7B
     decode shape [14, 32, 768, 128] bf16 (KV = 32 and 8, S = 700, a wholly
     masked row) and through ``sdpa_decode_stale`` at the T5-XL and
     KOSMOS-2 decode shapes in f32 (the current token merged), within 1e-2
     + 1e-2 |ref| (bf16) and 1e-5 + 1e-5 |ref| (f32), and at its edges
     (batch 1 at S = 4000: MHA, GQA, f32, a wholly masked range; S = 100);
     timed at the 7B shape and at the zoo's shapes in turns with
     ``scaled_dot_product_attention`` (a boolean mask; the zoo's f32
     additive bias), the card kept busy ahead of each timed call, beside
     the bound and the plain version.  Then K13, the packed-heads
     causal forward (Pallas rows 3 and 4: K1's kernel behind maps its entry
     encodes), at the prefill shape [7, 648, 32*128], the train shape [8,
     1024, 32*128], a ragged T with S > T and a ragged T = S, within 1e-2 +
     1e-2 |ref| of its plain version and, where S == T, bit-equal to K1 on
     the head views, its autograd function's dq, dk, dv within 2e-2 of the
     largest entry against autograd through the plain version, timed in turns
     with K1 and ``scaled_dot_product_attention(is_causal=True)`` on the head
     views, beside the bound and the plain version;
     and K14, the p32 product of the matmul probe (row 16): ``pack_p32``
     bit-equal to a numpy re-statement of the JAX script's packing, K14 at
     M = 1, 8 and 64 over [4096, 11008] within 1e-2 + 1e-2 |ref| of the f32
     plain version, two calls bit-identical, timed at M = 8 (the card kept
     busy ahead of each timed call, host us apart) beside the bound and the
     dense bf16 matmul on the unpacked weight.
  4. build random LLaVA-1.5-7B weights on the card from a seeded
     ``torch.Generator``: bf16 vision tower, projector, embeddings and head;
     int8 SmoothQuant LLM linears with smooth scales exp(N(0, 0.3)) shared
     per input group.
  5. check the kernel path against the plain path on a small input: the
     first two LLM layers at full width, prefill, one decode step and a
     W = 4 window forward with per-row write positions over a bf16 and an
     int8 cache, on the card and on the CPU.
  6. answer 14 VQA-shaped requests (641 real tokens right-padded to 648,
     576 image tokens, 336x336 pixels, 16 greedy tokens) through
     ``generate_prefill_chunked`` (chunk 7) + ``generate_decode``, twice;
     the tokens must be in the vocabulary and equal across the runs, and
     K1-K4 must have launched in the first run.
  6b. the same requests with the int8 KV cache and speculative windows of 4
     (cache of ``round_cache_len(648 + 16 + 4)`` slots) through
     ``generate_decode_spec``, twice, and once through ``generate_decode``
     over the int8 cache: tokens equal across the speculative runs, K5
     launched, window and token counts consistent, every speculative token
     the sequential step's argmax within 0.1 (teacher-forced replay), and
     every row whose greedy top-2 logit gaps all exceed 0.1 equal to the
     int8 greedy stream.  One more speculative run over the bf16 cache at
     8 layers drives K4 at W = 4 and is held the same way.
  6c. the greedy batch's prefill once more with ``CULLAVO_FLASH_PACKED=1``:
     its last-token logits ``torch.equal`` to the K1 prefill's (K13 is K1's
     kernel behind its own maps) and within 0.44 (largest) and 0.075 (mean)
     of a prefill through the plain attention, which a planted lost key tile
     must exceed; K13 launched 32 per chunk and K1 never, prefill seconds of
     both forms in turns.
  7. the serving path over an NF4 base: ``entry.serve`` once in its tiny
     smoke mode; then 7B weights with the LLM linears quantized to planar NF4
     target by target (``maybe_quantize_base``), the 2-layer check of phase 5
     on that base (an M = 528 prefill through K7, a W = 4 window and a
     32-token suffix prefill through K6), and a ``ServingEngine`` built by
     ``entry._engine_from_cfg`` from ``configs/serve.yaml``'s SERVE block
     (int8 KV cache, spec_k 4, prefix reuse, 16 slots) answering 24
     requests, 8 images x 3 questions, twice on fresh engines: results of the
     right length, 8 prefix misses, 16 hits and 16 x 608 tokens saved,
     identical tokens in both runs, every token the sequential step's argmax
     within 0.1 in a teacher-forced replay from a FULL prefill, and K1, K5,
     K6 and K7 launched.
  8. the train path: ``entry.train`` once in its tiny smoke mode; the
     2-layer full-width check of the Q-LoRA train step (loss and every
     gradient, kernel path on the card against the plain path on the CPU);
     then, over the NF4 base of phase 7, the state built by
     ``CuLLaVOPipeline.initialize_model`` (r = 64 adapters on the seven LLM
     targets and on vision layers 12-22, f32 masters, AdamW) and 4 steps of
     ``forward_step`` (remat, bf16 compute, chunked loss, dropout 0.05) on
     one batch of 8 right-padded to T = 1024, then the first 2 again from
     the same seed: every loss finite, the loss of step 4 below step 1,
     ``grad_norm`` finite and non-zero, the two runs' common steps equal
     within 1e-3 relative, the frozen base
     bit-unchanged, and K1-lse and K7 launched as often as the shapes say.
  8b. the package's ``attn_probe`` at its default shape, which runs K8.
  9. the X-Decoder eval path: ``entry.evaluate`` on
     configs/xdecoder_test.yaml with ``DATASETS.TEST`` unset (returns {});
     then both configurations (FocalNet-L + FPN, SAM-ViT-B + deformable
     encoder) at full width and cut depth, f32, on one 256 x 320 image,
     card (kernels) against CPU (plain versions): class embeddings, class
     and mask logits within 1e-3 of their largest entry; then each at full
     width and depth in bf16 (random weights, the 133 COCO panoptic
     classes + background through the 12-layer text encoder):
     ``XDecoderPipeline.evaluate_model`` with the semantic,
     panoptic and instance tasks on 16 synthetic images (12 of 512², 4 of
     480 x 640) with synthetic ground truth, batch 8, twice: identical
     outputs, ids in range, finite metrics, K10 24 and K9 6 launches per
     forward; images/s, compute s per batch and peak memory printed.
  10. the vl_test eval from a snapshot: random LLaVA-1.5-7B bf16 weights
     written as a snapshot in the HF layout (config.json with
     llava-hf/llava-1.5-7b-hf's widths, a LLaMA-style BPE tokenizer.json
     with <image> and <pad> at 32000/32001, bf16 safetensors shards by the
     port's own writer; full depth) and read back through the port's loader,
     bit for bit; then ``entry.evaluate`` on configs/vl_test.yaml (BITS 8,
     batch 8, 16 new tokens) with ``LOAD_PATH`` the snapshot over an
     in-memory VQA dataset of 16 questions on 8 random images, twice:
     n = 16, a finite accuracy in [0, 100], identical answers, K1, K3 and
     K4 launched, the prefill's linears through K3 (its launches by M
     printed); load seconds, prefill seconds, images/s and peak memory
     printed.
  10b. the byte-packed NF4 base: those weights' LLM linears as q4
     (``quantize_linear``) and as planar NF4; one weight's K11 dequant
     bit-equal to K7's; phase 5's 2-layer check on the q4 base; the
     14-request greedy batch over the q4 base twice (K11 launched 7 x 32 x
     15 times fused plus 7 x 32 per prefill chunk through its dequant
     entry); rows with decisive logits equal to the planar base's stream.
  11. the VL zoo: ``entry.evaluate`` with ``MODEL.ZOO`` blip2 and kosmos2
     at the JAX package's tiny configs on the card (4 questions each, K12
     launched); BLIP-2 Flan-T5-XL and KOSMOS-2 at full width and 2 layers
     per tower, f32 on the card against f64 on the CPU (the forward's
     logits and four decode steps); then each at full width and depth in
     f32 (3.94 G and 1.66 G random parameters built on the card) answering
     8 questions on 8 random 224^2 images through
     ``VLZooVQAPipeline.evaluate_model`` with its native answerer and the
     byte tokenizer, then the first 4 again (``ZOO_SECOND``): n = 8,
     identical answers, K12 launched as the shapes predict;
     questions/s, ms per question by phase, peak memory.
  12. the training loop: ``entry.train`` on configs/cullavo_step1.yaml
     (``BITS: 4``) with ``LOAD_PATH`` phase 10's snapshot (full width and
     depth) over a registered ``coco_panoptic`` dataset of 16 synthetic
     480 x 640 images (PNG images, id-encoded panoptic PNGs and a
     panopticapi JSON written with the port's PNG writer; thing and stuff
     segments, one crowd), batch 8, 1 epoch (2 steps), ``SAVE_DIR`` a
     temporary directory: every loss finite, ``step_2`` and ``epoch0``
     written, the npz store read back with the TrainState as template and
     the reference layout read back, both bit-equal to the state they
     saved; then ``RESUME_FROM`` epoch0 for 1
     step (its trainable partition before the step bit-equal to the first
     run's final one); then 1 step with ``CULLAVO_FLASH_PACKED=1``: its loss
     within 1e-3 relative of the first run's step 1, K13 launched 64 and
     K1-lse 32.  Both single steps on ``first_batch_dataset`` (run 1's first
     batch).  Seconds per step, checkpoint write seconds and peak memory
     printed.
  13. the port's matmul probe (``scripts/matmul_probe.main``) at M = 8 over
     24 stacked [4096, 11008] weights with the p32 variants: every variant's
     JSON line, parity to the first within 2e-2, K14 launched as predicted.
  14. step2_pre data generation from phase 10's snapshot (run before phase
     13, while the snapshot exists): ``python -m cullavo_tpu_torch eval
     --conf_files configs/cullavo_step2_pre.yaml`` in a subprocess over a
     registered conversations dataset of 12 rows (PNG images of 336^2 and
     480 x 640), 128 sampled tokens (the config's 256, cut; temperature
     0.9, top-k 50, top-p 0.95)
     in two chunks of 8, the second padded by repetition: exit 0,
     ``lbk_new_version.json`` well-formed; then in this process the first
     chunk's sampled fused ``generate`` twice from its seed (equal tokens;
     K1 32 and K4 32 per decode step launched; seconds, tokens/s, peak
     memory), the greedy fused ``generate`` against ``generate_prefill`` +
     ``generate_decode`` at 32 tokens (equal streams), and the top-k/top-p
     filter of the prefill's logits on the card equal to the CPU's.
  15. X-Decoder joint training (configs/xdecoder_train.yaml: FocalNet-L +
     FPN, 201 queries, 10 decoder layers, 12-layer text encoder, batch 8
     at 512^2, bf16 over f32 masters, remat): (a) ``entry.train`` without
     ``DATASETS.TRAIN`` returns None; (b) K10's autograd Function at the
     train step's stage-1 shape [8, 192, 128 x 128] in f32 and bf16 and
     K9's at phase 9's deformable shape: every input gradient within 1e-3
     of autograd through the plain version (K10's forward and plain
     backward timed); (c) full width at cut depth, f32, 2 images of 512^2,
     points pinned: every loss within 1e-3 and every gradient leaf within
     1e-3 in its 2-norm (1e-2 entry by entry: ReLU / GroupNorm kinks flip
     on f32 rounding), card against CPU; (d) over a registered caption-grounding dataset of 16 synthetic
     images (12 of 512^2, 4 of 480 x 640), ``entry.train`` in process on
     ``python -m cullavo_tpu_torch train``'s arguments (the command line
     itself runs on two ranks in phase 22b), 2 steps: every reference loss
     key finite, grad_norm > 0, the checkpoint read back bit-equal, K10
     launched 48 times a step; (e) 4 steps on one batch, then 1 again from
     one seed (step-1 losses within 1e-3 relative; s per step,
     images/s, the matcher's host seconds, peak memory); (f) 6 steps at
     BASE_LR 1e-3: the loss falls.  The kernels line gains
     ``xdecoder_train_launches``.
  16. the X-Decoder eval from a reference checkpoint (in phase 15's working
     directory): (a) random FocalNet-L + FPN and SAM-ViT-B + deformable
     weights at full width and depth written in the reference's key names
     as ``.pt`` files (``checkpoint.xdecoder_import``'s inverse table) and
     read back through ``RESUME_FROM`` bit-equal; the FocalNet-L file under
     FocalNet-T widths raises; (b) a CLIP ``vocab.json`` + ``merges.txt`` of
     49408 ids synthesized here (<|startoftext|> 49406, <|endoftext|>
     49407); (c) ``semseg`` (phase 9's 16 sizes, 150 ADE20K names, grey
     annotation PNGs), ``coco_panoptic`` (phase 12's writer) and
     ``refcoco`` (16 sentences on 8 images, polygons and an RLE) datasets of
     PNGs; (d) ``evaluate_grounding`` at full width and cut depth, f32,
     card against CPU within 1e-3 of the largest mask logit; (e) ``python
     -m cullavo_tpu_torch eval --conf_files configs/xdecoder_test.yaml`` in
     a subprocess with ``RESUME_FROM``, ``MODEL.TEXT.TOKENIZER`` and the
     three datasets (exit 0; mIoU, PQ, grounding cIoU / mIoU finite and in
     [0, 100]), then ``entry.evaluate`` on the same arguments in bf16 in
     this process twice (equal metrics; K10 24 a forward), and the
     grounding set from phase 15's trained checkpoint; (f) load seconds,
     tokenizer seconds per 1000 texts, images/s and compute seconds per
     batch by dataset, peak memory.  The kernels line gains
     ``xdecoder_eval_launches``.
  17. the X-Decoder's VLP eval and DaViT (in phase 16's working directory,
     from its FocalNet-L ``.pt`` and CLIP files): (a) a
     ``DETECTRON2_DATASETS`` root whose ``vlp/pretrain_arrows_code224``
     holds a karpathy test arrow written by the port's writer (phase 9's 16
     sizes as PNG bytes, 5-7 captions, two record batches), read back equal;
     (b) FocalNet-L at full width and cut depth in f32 on two 224² images,
     card against CPU: ``evaluate_retrieval_embedding`` within 1e-3, greedy
     ``forward_captioning``'s step logits replayed teacher-forced on the
     card's ids within 1e-3 of the largest, ids equal where every step's
     top-2 gap exceeds 0.1; (c) ``python -m cullavo_tpu_torch eval
     --conf_files configs/xdecoder_test.yaml`` in a subprocess on
     ``vlp_val`` and ``vlp_captioning_val`` (exit 0, recall in [0, 100],
     CIDEr / BLEU / ROUGE-L / METEOR_approx finite, 16 captions written);
     (d) ``entry.evaluate`` on the same arguments in bf16 twice (equal
     metrics and captions; K10 24 times a forward, 2 retrieval and 2
     captioning forwards); (e) DaViT-d3: random weights at full width and
     depth written through the inverse table and read back bit-equal, a
     cut-depth card-vs-CPU check (res2-res5, class and mask logits within
     1e-3), then configs/xdecoder/davitd3_unicl_lang.yaml at full depth in
     bf16 on phase 16's ``semseg`` and ``coco_panoptic`` sets and
     ``vlp_val`` (metrics in range, no kernel launched); (f) load seconds,
     retrieval images/s, captioning s a batch and ms a decode step, DaViT-d3
     images/s and compute s a batch, peak memory.  The kernels line gains
     ``vlp_eval_launches``.
  18. the rest of ``serve`` (run right after phase 7, on its 7B NF4
     parameters): (a) ``python -m cullavo_tpu_torch serve --conf_files
     configs/serve.yaml`` with ``SERVE.PORT 0`` in a subprocess (the tiny
     smoke model): the port read from its stderr line, /healthz, a blocking
     and a streamed POST /generate, /stats with 2 completed, then SIGINT and
     exit 0 within HTTP_EXIT_S; (b) two r = 64 adapter sets on the seven LLM
     targets (random A and B) written with ``save_adapters`` and read back
     bit-equal; (c) an engine from ``entry._engine_from_cfg`` (the SERVE
     block + ``ADAPTERS``) behind ``make_server`` on 127.0.0.1:0: phase 7's
     24 requests (images as ``.npy`` paths, adapter ids alternating) from 8
     client threads, 8 streamed: all 200, each stream's tokens its final
     line's, every token its own set's teacher-forced argmax within 0.1,
     most streams not the other set's, /stats 24 completed with at least 16
     prefix misses (keys by image and adapter), 400 for a duplicate id in
     flight, an over-long prompt and ``adapter_id`` 2, 404 for an unknown
     path, K1, K5, K6 and K7 launched; (d) ``DO_SAMPLE: true`` (SPEC_K
     switched off): the 24 requests offline twice from one seed, identical
     tokens, every draw inside its replayed top-k / top-p set within
     SAMPLE_MARGIN, K5 at W = 1; (e) ms per quantum and per forward with
     and without the stack; requests/s, tokens/s, TTFT / E2E, peak memory.
     The kernels line gains ``serve_http_launches``.  With ``--profile``,
     at the end: one 16-row decode forward without adapters, with one set
     and with the two-set stack under torch.profiler.
  19. the rest of the VL zoo (after phase 17): (a) InstructBLIP
     (Salesforce/instructblip-vicuna-7b: EVA-ViT-g, the text-input
     Q-Former, Vicuna-7B), f32: a card-vs-CPU check at 2 layers per tower
     and full width (forward logits with the question into the Q-Former,
     the prefill's last logits, four decode steps; K12 8 launches), then
     ``entry.evaluate`` with ``MODEL.ZOO: instructblip`` (the tiny smoke
     tower, 4 questions), then 7.9 G random parameters built on the card
     answering phase 11's 8 questions through ``VLZooVQAPipeline`` with the
     native answerer (beam 5, length penalty -1, 10 tokens), then the first
     4 again: n = 8, identical answers, K12 launched 32 x
     9 x 8 and nothing else;
     questions/s, ms per question (vision + Q-Former, the Vicuna prefill,
     beam decode, host), peak memory; (b) the zero-shot ImageNet eval on
     that tower's EVA-ViT-g and Q-Former: a 2-layer card-vs-CPU check of
     the image and text embeddings (1e-4), 8 synset folders x 8 PNGs of
     224^2 written here, ``python -m cullavo_tpu_torch eval`` with ``NAME:
     imagenet_test`` and a ``KIND: imagenet`` root in a subprocess (the
     smoke tower; exit 0, n = 64, the per-class CSV) equal to
     ``entry.evaluate`` in this process, then the full-width tower over the
     1000 ImageNet names twice (equal top-1 / top-5; images/s, text-embedding
     seconds, peak memory); (c) the topic classifier at LLaMA-2-7B
     (bf16) and CLIP-L/336's text tower (f32), random, over 16 questions in
     the 256 and 320 prompt buckets, then the first 8 again, from one seed:
     equal classes, K1
     32 a question and K4 32 a decode forward; ms per question (generate,
     CLIP), peak memory; then ``entry.evaluate`` on vl_test with
     ``MODEL.TOPIC: tiny`` and ``SAVE_DIR`` (the per-topic CSV read back).
     The kernels line gains ``vl_zoo_rest_launches``.  Phase 3 also holds
     K12 at InstructBLIP's decode shape ([5, 32, 96, 128] f32 through the
     S-major view), timed beside ``scaled_dot_product_attention``.
  20. the zoo from local HF snapshots (after phase 19): (a) BakLLaVA-1
     (llava-hf/bakLlava-v1-hf: CLIP-L/336 over Mistral-7B, 32 heads over 8 kv
     heads, sliding window 4096) at full width and depth in bf16, random on
     the card: a 2-layer full-width card-vs-CPU check under the window (K1
     in a 320-token prefill, K4 in four decode steps) and under a window of
     256 (it binds: the prefill's plain attention with the window's bias,
     counted, and K4 with it); the snapshot written in the llava-hf layout
     (Mistral's config.json, the BPE tokenizer) and read back bit for bit;
     ``python -m cullavo_tpu_torch eval`` with ``MODEL.ZOO: bakllava`` and
     ``MODEL.ZOO_PATH`` in a subprocess over 4 of 16 questions written as
     a ``vqa`` dataset, then the first 8 through ``entry.evaluate`` here: the
     CLI's answers equal, K1 32 a question (GQA's k/v repeated) and K4 32 a decode
     forward (n_rep 4); (b) Salesforce/blip2-flan-t5-xl,
     instructblip-vicuna-7b and microsoft/kosmos-2-patch14-224 at full width
     and cut depth (``ZOO_PATH_CUT``) in f32, written with the port's
     exporters and synthetic tokenizers of the published sizes (Unigram
     32128 with a SentencePiece charsmap, WordPiece 30522 + [DEC], Unigram
     65037), each through ``entry.evaluate`` with ``MODEL.ZOO_PATH`` over
     phase 11's 8 questions (K12 only), and ``imagenet_test`` from the
     InstructBLIP snapshot; load s, questions/s, peak memory.  The kernels
     line gains ``vl_zoo_path_launches``.  Phase 3 also holds and times K1
     at BakLLaVA's prefill ([1, 32, 592, 128] bf16, k/v repeated from 8
     heads) and K4 at its decode (n_rep 4, one layer of a 608-slot cache,
     the window's bias at 4096 and at 256): ``bakllava_shape`` on the
     kernels line.
  21. BLIP-2 OPT (after phase 20): (a) Salesforce/blip2-opt-2.7b (EVA-ViT-g,
     the Q-Former, OPT 32 x 2560 with 32 heads of 80) in f32, random on the
     card: a 2-layer full-width card-vs-CPU check (K12 8 launches), then 8
     questions through ``native_blip2_answer_fn(kind="opt")`` (beam 5,
     length penalty -1, 10 tokens) and the first 4 again: identical answers,
     K12 32 x 9 x 8 and nothing else; questions/s, ms per question by
     phase, peak memory; (b) a blip2-opt-2.7b-shaped snapshot at
     ``ZOO_PATH_CUT`` depth (GPT-2's byte-level BPE of 50265 ids) written,
     read back bit for bit and answering the 8 questions through the
     snapshot answerer (K12 only).  The kernels line gains
     ``vl_zoo_opt_launches``.  Phase 3 also holds and times K12 at OPT's beam
     shape ([5, 32, 104, 80] f32, one layer of the head-major cache).
  22. several processes over ``torch.distributed`` (the data axis), each
     rank ``entry.main`` as ``python -m cullavo_tpu_torch`` runs it, on this
     card over Gloo, started as ``chip_smoke.py --rank -- ARGS`` so that it
     reports its kernels' launches: (a) after phase 12, its run 1 (Q-LoRA
     at 7B from phase 10's snapshot, batch 8 x 1024 split 4 + 4, 2 steps)
     on two ranks: losses and gradient norms equal across ranks and within
     ``PAR_TOL["qlora"]`` of phase 12's, each rank's launches equal to that
     run's, only rank 0 writing; s per step, the gradient all-reduce's ms
     and share, peak GiB a rank; (b) after phase 15, its in-process
     X-Decoder run (FocalNet-L at 512², 2 steps of 8 split 4 + 4,
     ``MESH_DATA: 2``) the same way (``PAR_TOL["xtrain"]``), in place of
     phase 15's one-process CLI run; (c) after phase 14, step2_pre through
     the CLI on two ranks from phase 10's snapshot at ``STEP2_PAR_NEW``
     tokens (the rows merged, written once; K1 once a layer and chunk, K4
     whole decode steps), in place of phase 14's one-process CLI run; (d)
     one rank over NCCL in this process: a 2-layer 7B-width Q-LoRA step
     through a ``Layout`` bit-equal to the step without a process group,
     launches equal, and an NCCL all-reduce of its loss.  The
     kernels line gains ``two_rank_launches``.  Paid for by those two CLI
     runs, phase 14's replay at 32 tokens, phase 15's second seeded run at
     1 step, phase 17's second in-process run at 16 rows, the zoo's second
     runs at 4 questions (phases 11, 19a, 21a), the topic classifier's at 8
     and BakLLaVA's CLI at 4.
  23. the fsdp and tensor axes (``MESH_FSDP``, ``MESH_TENSOR``) on two ranks
     of this card over Gloo, run as phase 22's: (a) after phase 22a, phase
     12's run 1 (2 steps, ``EPOCHS 1``) under ``MESH_FSDP: 2``;
     (b) its first step under ``MESH_TENSOR: 2`` (an 8-record copy of the
     dataset whose epoch draws run 1's first batch); (c) after phase 22b,
     phase 15's X-Decoder run under ``MESH_FSDP: 2``.  Each: losses and
     gradient norms equal across ranks and within ``PAR_TOL`` of the
     one-process run's same steps, each rank launching K7, K1-lse and K10
     per step as that run did, only rank 0 writing (its checkpoint read
     back); s per step, the gathers' and reductions' ms and share, each
     rank's resident GiB after the run, its step peak and its load's peak
     beside phase 22a's data-axis ranks; (a) fails where a rank keeps more
     than ``SHARD_RESIDENT_MAX`` of a 22a rank's resident memory or other
     than half of the NF4 base.  The kernels line gains
     ``sharded_launches``.  Paid for by phase 22a at 2 steps (``EPOCHS
     1``), phase 12's run 1 at 1 epoch and its second runs at 1 step each,
     phase 8's second run at 2 steps, phase 14 at 128 tokens, phase 22c at
     32, the VL zoo's 8 questions (phases 11, 19a, 20b, 21) and BakLLaVA's
     8 in process.  ``--par-calibrate sharded`` runs only the sharded readings
     (``MESH_FSDP: 2`` at 3 seeds, ``MESH_TENSOR: 2`` at one, the
     ``local_norm`` fault).
The last two lines are the kernels' JSON record and the result line.
Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import ast
import collections
import contextlib
import dataclasses
import functools
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH, CHUNK, PROMPT_TEXT, PAD_TO, NEW_TOKENS = 14, 7, 64, 8, 16
SPEC_K, SPEC_BF16_LAYERS, LOGIT_TOL = 4, 8, 0.1
# phase 6c: the packed (K13) prefill's last-token logits against a prefill
# through the plain attention, absolute (the logits reach |4.1|, 0.8 on
# average).  The sound kernel sits 0.2275 at most and 0.0400 on average from
# it after 32 random-weight bf16 layers (its P and O round at other places);
# a planted lost key tile (``faulty_attention``) sits 0.8402 / 0.1408 away
# (NVIDIA H100 80GB HBM3, 700.00 W).  Each bound is the geometric mean of
# the two readings, about 1.9x from each
PACKED_LOGIT_TOL, PACKED_LOGIT_MEAN_TOL = 0.44, 0.075
NF4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))   # (K, N) of the 7B linears
# K3's M on the paths: vl_test's decode (8 prompts), the greedy batch, the
# speculative windows (14 x 4), vl_test's prefill (8 x 704)
INT8_M = (8, BATCH, BATCH * SPEC_K, 5632)
# configs/serve.yaml's SERVE block, with the prompt bucket of the traffic below
SERVE_CFG = {"REQUESTS": None, "RESULTS": "serve_results.jsonl", "SLOTS": 16, "QUANTUM": 8,
             "PREFILL_CHUNK": 4, "PROMPT_BUCKETS": [648], "KV_QUANT": "int8", "SPEC_K": 4,
             "EOS_TOKEN_ID": 2, "DO_SAMPLE": False, "PREFIX": True, "ADMIT_GROUPS": 1}
SERVE_MODEL_CFG = {"LLM": {"LOAD_PATH": None, "BITS": 4}}
SERVE_IMAGES, SERVE_QUESTIONS, SERVE_HEAD_TEXT, SERVE_SHARED_TEXT = 8, 3, 4, 32
SERVE_OWN_TEXT, SERVE_BUDGETS = (8, 28), (8, 16, 24, 32)
SERVE_DECODE_M = SERVE_CFG["SLOTS"] * SERVE_CFG["SPEC_K"]
SERVE_SUFFIX_W = (32, 64, 128)   # the engine's default suffix buckets
# phase 18: two r = 64 adapter sets on the seven LLM targets (alpha 16:
# scaling 0.25), A ~ N(0, 1/d_in) as init_lora_params draws it and B ~
# N(0, ADAPTER_B_STD^2) (PEFT's zero B would make every adapter a no-op); the
# HTTP traffic is phase 7's 24 requests with adapter ids alternating 0 / 1 from
# HTTP_CLIENTS client threads, every HTTP_STREAM_EVERY-th request streamed; a
# sampled token may lie SAMPLE_MARGIN (logit) below the least logit of its
# replayed top-k / top-p set; the entry point exits within HTTP_EXIT_S of SIGINT
ADAPTER_R, ADAPTER_ALPHA, ADAPTER_B_STD = 64, 16, 0.05
HTTP_CLIENTS, HTTP_STREAM_EVERY, SAMPLE_MARGIN, HTTP_EXIT_S = 8, 3, 0.1, 10.0
# configs/cullavo_step1.yaml (the Q-LoRA train step), its dataset left unset
TRAIN_CFG = {"NAME": "cullavo_step1", "PIPELINE": "CuLLaVOPipeline", "WORKLOAD": "step1",
             "EPOCHS": 1, "BATCH_SIZE": 8, "LR": 2.0e-5, "LAST_LR": 0.0, "GRAD_MAX": 10.0,
             "GRAD_CUM": 1, "PERIOD": 10, "SEED": 0, "SAVE_DIR": None,
             "MODEL": {"LLM": {"BITS": 4, "LORA_R": 64, "LORA_ALPHA": 16, "GRAD_CKPT": True,
                               "LOAD_PATH": None}},
             "DATASETS": {"TRAIN": None}}
TRAIN_T, TRAIN_STEPS, TRAIN_LEN_RANGE = 1024, 4, (700, 1024)
PROBE_SHAPE = (6, 32, 648, 128)   # the attention probe's default shape
# the training loop (phase 12): a registered coco_panoptic dataset of this
# many synthetic images of COCO's common 480 x 640
LOOP_DATASET, LOOP_IMAGES, LOOP_IMAGE_HW = "coco_2017_train_panoptic_synthetic", 16, (480, 640)
# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense operations/s by input type
HBM_BPS = 3.35e12
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# the X-Decoder eval path: configs/xdecoder_test.yaml (FocalNet-L + FPN) and
# configs/xdecoder/samvitb_deform_lang.yaml (SAM-ViT-B + deformable encoder),
# as the dicts their yaml files hold (this script reads no yaml); images
# as bench_xdecoder.py evaluates them (512^2, batch 8, bf16)
_XDEC_DECODER = {"HIDDEN_DIM": 512, "NUM_OBJECT_QUERIES": 201, "NHEADS": 8,
                 "DIM_FEEDFORWARD": 2048, "DEC_LAYERS": 10}
_XDEC_TEXT = {"WIDTH": 512, "HEADS": 8, "LAYERS": 12, "CONTEXT_LENGTH": 77}
XDEC_CONFIGS = {
    "configs/xdecoder_test.yaml": {
        "NAME": "xdecoder_test", "PIPELINE": "XDecoderPipeline",
        "MODEL": {"BACKBONE": {"NAME": "focal", "EMBED_DIM": 192, "DEPTHS": [2, 2, 18, 2],
                               "FOCAL_LEVELS": [4, 4, 4, 4], "FOCAL_WINDOWS": [3, 3, 3, 3]},
                  "ENCODER": {"NAME": "transformer_encoder_fpn", "CONVS_DIM": 512,
                              "MASK_DIM": 512, "NUM_CLASSES": 133},
                  "DECODER": dict(_XDEC_DECODER), "TEXT": dict(_XDEC_TEXT)},
        "DATASETS": {"TEST": None}},
    "configs/xdecoder/samvitb_deform_lang.yaml": {
        "NAME": "xdecoder_test_samvitb_deform", "PIPELINE": "XDecoderPipeline",
        "MODEL": {"BACKBONE": {"NAME": "vit", "VIT": {"SIZE": "base", "OUT_FEATURES": [
                      "res2", "res3", "res4", "res5"]}},
                  "ENCODER": {"NAME": "transformer_encoder_deform", "CONVS_DIM": 512,
                              "MASK_DIM": 512, "NUM_CLASSES": 133,
                              "DEFORMABLE_TRANSFORMER_ENCODER_IN_FEATURES": [
                                  "res3", "res4", "res5"],
                              "COMMON_STRIDE": 4, "TRANSFORMER_ENC_LAYERS": 6},
                  "DECODER": dict(_XDEC_DECODER), "TEXT": dict(_XDEC_TEXT)},
        "DATASETS": {"TEST": None}},
}
XDEC_FOCAL, XDEC_DEFORM = XDEC_CONFIGS   # the two paths, by config file
XDEC_BATCH, XDEC_SIDE, XDEC_DATASET = 8, 512, "coco_2017_val_panoptic_with_sem_seg"
XDEC_SIZES = ((512, 512),) * 12 + ((480, 640),) * 4   # the last four: bucket 512 x 640
XDEC_CHECK_HW = (256, 320)
# the VLP eval (phase 17): VLP_IMAGE_SIZE, the karpathy-style arrow's images
# (phase 9's sizes) and their captions
VLP_SIDE = 224
XDEC_THINGS = frozenset(range(80))   # COCO panoptic: the first 80 classes are things
# X-Decoder joint training (phase 15): configs/xdecoder_train.yaml (FocalNet-L +
# FPN, batch 8 at 512^2, bf16 over f32 masters, remat) over a registered
# coco_panoptic_caption_grounding dataset of 16 synthetic images (phase 9's
# sizes), 1 epoch = 2 steps; the card-vs-CPU check runs 2 images of 512^2 at
# cut depth in f32; the determinism and learning runs take 4 and 6 steps on
# the first batch (learning: BASE_LR 1e-3, no warmup); K10 launches a step:
# the 24 blocks' forwards and their 24 remat recomputations
XTRAIN_CFG = "configs/xdecoder_train.yaml"
XTRAIN_DATASET = "coco_2017_train_panoptic_caption_grounding_synthetic"
XTRAIN_CUT_IMAGES, XTRAIN_DET_STEPS, XTRAIN_LEARN_STEPS, XTRAIN_LEARN_LR = 2, 4, 6, 1e-3
XTRAIN_FOCAL_PER_STEP = 2 * 24
XTRAIN_LOSS_KEYS = tuple(
    [f"loss_{n}_{r}" for n in ("mask_ce", "mask_bce", "mask_dice", "bbox", "giou")
     for r in range(10)]
    + [f"loss_{n}_{r}" for n in ("caption", "captioning", "retrieval_decoder", "grounding_bce",
                                 "grounding_dice", "grounding_ce") for r in range(3)]
    + ["loss_retrieval_backbone_0"])
# the VL eval path: configs/vl_test.yaml as the dict it holds, over a
# LLaVA-1.5-7B snapshot written in llava-hf/llava-1.5-7b-hf's layout and an
# in-memory VQA dataset (records carry decoded images: no PIL beside the card)
VL_CFG = {"NAME": "vl_test", "PIPELINE": "LLaVAVQAVALPipeline", "BATCH_SIZE": 8,
          "MAX_NEW_TOKENS": 16, "LIMIT": 0, "MODEL": {"LLM": {"LOAD_PATH": None, "BITS": 8}},
          "DATASETS": {"TEST": None}}
VL_DATASET, VL_IMAGES, VL_QUESTIONS = "chip_vqa_synthetic", 8, 16
VL_IMAGE_HW = ((480, 640), (336, 336), (640, 480), (375, 500))
VL_SHARD_LAYERS = 8          # LLM layers per safetensors shard
TOKENIZER_MERGES = 400
_OBJECTS = ("car", "dog", "cat", "man", "woman", "bicycle", "table", "plate", "sofa", "window",
            "giraffe", "horse", "bus", "train", "umbrella", "kite", "pizza", "clock", "bird",
            "boat")
_ATTRS = ("color", "size", "shape", "name", "number", "type")
TOKENIZER_CORPUS = tuple(
    ["A chat between a curious human and an artificial intelligence assistant. The assistant "
     "gives helpful, detailed, and polite answers to the human's questions."]
    + [f"USER: What is the {a} of the {o}? ASSISTANT: the {o} is {a}"
       for o in _OBJECTS for a in _ATTRS]
    + [f"USER: How many {o}s are there in the picture? ASSISTANT: two {o}s" for o in _OBJECTS]
    + [f"USER: Is the {o} next to the {o2}? ASSISTANT: yes, it is"
       for o, o2 in zip(_OBJECTS, _OBJECTS[1:])])
VL_QUESTION_TEXT = ("What is the color of the car?", "How many dogs are there?",
                    "Is the man riding a bicycle?", "What is on the table?",
                    "Where is the cat sitting?", "What sport is being played?",
                    "What time of day is it?", "Are there any people in the picture?")
VL_ANSWERS = ("red", "two", "yes", "no", "food", "sofa", "tennis", "night")
# the VL zoo path: Salesforce/blip2-flan-t5-xl and microsoft/kosmos-2-patch14-224
# at full width and depth in f32 (as the pipeline's ModelSpec loads them), each
# answering 8 questions (16 before phase 23 had to be paid for) on 8 random
# 224^2 images with its reference decode
# (BLIP-2: beam 5, length penalty -1; KOSMOS-2: greedy), <= 10 new tokens
ZOO_DATASET, ZOO_IMAGES, ZOO_QUESTIONS, ZOO_SIDE, ZOO_NEW, ZOO_BEAMS = (
    "chip_vqa_zoo", 8, 8, 224, 10, 5)
# the card-vs-CPU check: layers per tower; the card's f32 error against the
# CPU's f64 result may be ZOO_TOL times the CPU's own f32 error, + 1e-5 max |ref|
ZOO_CUT, ZOO_TOL = 2, 4.0
# phase 11's second run of each tower answers the first ZOO_SECOND questions
# (its identical-answers check; 8 to pay for phase 20, 4 for phases 21-22;
# phases 19a and 21a take the same)
ZOO_SECOND = 4
# the zoo from local snapshots (phase 20): BakLLaVA-1's cut-depth checks
# prefill BAK_CUT_T text tokens, once under Mistral's window and once under a
# window of BAK_CUT_WINDOW, which binds in the prefill and the decode; the
# BLIP-2 / InstructBLIP / KOSMOS-2 snapshots keep the published widths with
# these depths (phases 11 and 19a run the towers at full depth)
BAK_CUT_T, BAK_CUT_WINDOW = 320, 256
# phase 3 times K1 and K4 at a BakLLaVA VQA prompt's length: 1 + 576 image
# tokens + the text of 'USER: <image>\n{q} ASSISTANT:' under the port's BPE
BAK_PROMPT_T = 592
# its CLI run answers the first BAK_CLI_QUESTIONS of phase 9's 16 (process,
# load), the run in this process the first BAK_QUESTIONS (16 before phase 23
# had to be paid for)
BAK_CLI_QUESTIONS, BAK_QUESTIONS = 4, 8
ZOO_PATH_CUT = {"vision": 4, "qformer": 2, "text": 4}
# step2_pre (phase 14): configs/cullavo_step2_pre.yaml through the command line
# over a registered conversations dataset of this many rows whose images are
# PNGs of these sizes; MAX_NEW_TOKENS cut from the config's 256 to STEP2_NEW (to
# pay for phase 23) and the default BATCH_SIZE (8);
# the greedy fused-vs-two-phase check decodes STEP2_CHECK_NEW tokens
STEP2_CFG = "configs/cullavo_step2_pre.yaml"
STEP2_DATASET, STEP2_ROWS, STEP2_IMAGE_HW = "chip_conversations_synthetic", 12, (
    (336, 336), (480, 640))
STEP2_NEW, STEP2_BATCH, STEP2_CHECK_NEW, STEP2_TURNS = 128, 8, 32, 3
# the X-Decoder eval from a checkpoint (phase 16): configs/xdecoder_test.yaml
# through the command line and entry.evaluate, RESUME_FROM a reference-layout
# .pt of random weights, MODEL.TEXT.TOKENIZER a synthesized CLIP vocabulary of
# CLIP's size, and three registered datasets of phase 9's image sizes
CLIP_VOCAB = 49408


def log(*a):
    print(*a, flush=True)


def bench_ms(fn, device, reps=20, lead_cycles=0):
    """Median ms of ``fn`` over ``reps`` launches, CUDA events around each,
    with the 50 MB L2 flushed before every launch (the main path meets each
    weight cold).  ``lead_cycles`` > 0 keeps the card busy that many clock
    cycles before the start event, so that the host's work in ``fn`` (the
    wrapper's checks and launch) is queued before the card reaches it and
    the events time the card alone."""
    import torch

    flush = torch.empty(64 * 1024 * 1024, dtype=torch.float32, device=device)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        if lead_cycles:
            torch.cuda._sleep(lead_cycles)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end))
    del flush
    return statistics.median(times)


def bound(n_bytes, n_ops, op_type):
    """The least ms the card could take: each input byte read once and each
    output byte written once at the memory rate, against the operations at
    the peak rate of their type; and which of the two it is."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / PEAK_OPS[op_type] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def device_seconds(ka):
    """The device time of a profile's ``key_averages()``: the self times of
    its device-side events (kernels, copies); an operator's row repeats the
    time of the kernels it launched, so summing every row counts it twice."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in ka if e.device_type == DeviceType.CUDA) / 1e6


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def focal_taps_in_map(h, w, kernels):
    """The taps of K10's depthwise levels that land inside an h x w map,
    summed over its output pixels: a tap on the zero padding is no work the
    function needs.  Per level the count is separable, the in-map taps of
    the rows times those of the columns."""
    def axis(n, k):
        p = k // 2
        return sum(min(i + p, n - 1) - max(i - p, 0) + 1 for i in range(n))

    return sum(axis(h, k) * axis(w, k) for k in kernels)


def check_kernels(device):
    """Phase 3: kernel vs plain version at main-path shapes."""
    import torch

    from cullavo_tpu_torch.ops import nf4

    g = torch.Generator(device=device).manual_seed(SEED + 1)
    bf = torch.bfloat16
    rec = {}

    rec.update(check_flash_sm90(device, g))

    # K2: per-row quantizer, codes and sx bit-equal; timed card alone at the
    # greedy batch's prefill chunk (K = 4096 and the down projection's 11008)
    T = PAD_TO * -(-(1 + 576 + PROMPT_TEXT) // PAD_TO)   # the greedy batch's prompt length
    k2_timed = {}
    for M, K, kind in ((1296, 4096, bf), (1296, 11008, bf), (CHUNK * T, 4096, bf),
                       (CHUNK * T, 11008, bf), (1, 16, None), (7, 24576, torch.float32),
                       (CHUNK * T + 1, 11008, None), (CHUNK * T + 1, 4096, torch.float32)):
        x = torch.randn((M, K), generator=g, device=device).to(bf) * 3
        mult = None if kind is None else (
            1.0 / torch.exp(torch.randn((1, K), generator=g, device=device) * 0.3)).to(kind)
        xi, sx = nf4.quantize_rows(x, mult)
        xr, sr = nf4._quantize_rows_plain(x, mult)
        torch.cuda.synchronize(device)
        n_bad = int((xi != xr).sum().item())
        sx_bad = int((sx != sr).sum().item())
        log(f"K2 quant_rows [{M}, {K}] mult {kind}: code mismatches={n_bad}, sx mismatches="
            f"{sx_bad} (bit-equal demanded)")
        if n_bad or sx_bad:
            raise RuntimeError(f"K2 disagrees with its plain version at [{M}, {K}]")
        if M == CHUNK * T:
            t = bench_turns({"kernel": lambda: nf4.quantize_rows(x, mult)}, device, rounds=3,
                            lead_cycles=1_000_000)["kernel"]
            plain = bench_ms(lambda: nf4._quantize_rows_plain(x, mult), device)
            # ~6 f32 operations per element; no single PyTorch call does it
            bd = bound(nbytes(x, mult, xi, sx), 6 * M * K, "f32")
            host = round(host_us(lambda: nf4.quantize_rows(x, mult), device), 1)
            log(f"K2 [{M}, {K}]: kernel {statistics.median(t):.4f} ms card alone (rounds "
                f"{[round(v, 4) for v in t]}, host {host} us per call), plain {plain:.4f} ms, "
                f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']})")
            k2_timed[K] = dict(ms=statistics.median(t), plain_ms=plain, library_ms=None, **bd,
                               host_us=host, shape=f"x [{M},{K}] bf16 + sq_inv bf16")
        # the library int8 GEMM of the s8s8 path, exact against f64
        if K == 11008 and M == CHUNK * T:
            q8 = torch.randint(-127, 128, (K, 4096), generator=g, device=device,
                               dtype=torch.int8)
            acc = nf4._int_dot(xi, q8)
            exact = (xi.double() @ q8.double()).to(torch.int32)
            if not torch.equal(acc, exact):
                raise RuntimeError("s8s8 int8 GEMM (torch._int_mm) is not exact")
            gemm_ms = bench_ms(lambda: nf4._int_dot(xi, q8), device, reps=10)
            rm_ms = bench_ms(lambda: torch._int_mm(xi, q8), device, reps=10)
            log(f"s8s8 GEMM [{M}, {K}] x [{K}, 4096] (torch._int_mm): exact; "
                f"{gemm_ms:.4f} ms with the column-major copy, {rm_ms:.4f} ms on the "
                "row-major weight as stored")
    rec["quant_rows"] = dict(k2_timed[4096], other_shapes={"[4536,11008]": k2_timed[11008]})
    rec["quant_rows"]["max_abs_err"] = 0.0

    rec.update(check_int8_kernel(device, g))
    rec.update(check_wwin_kernels(device, g))
    rec.update(check_nf4_kernels(device, g))
    rec.update(check_q4_kernels(device, g))
    rec.update(check_train_kernels(device, g))
    rec.update(check_xdecoder_kernels(device, g))
    rec.update(check_decode_kernels(device, g))
    rec.update(check_packed_kernel(device, g))
    rec.update(check_p32_kernel(device, g))
    for name, shape in check_bakllava_shapes(device, g).items():
        rec[name]["bakllava_shape"] = shape
    return rec


def check_bakllava_shapes(device, g):
    """Phase 3, K1 and K4 at BakLLaVA's shapes (phase 20): Mistral's 32
    query heads over 8 kv heads.  K1 on a VQA prompt's prefill, [1, 32,
    ``BAK_PROMPT_T``, 128] bf16 causal with k/v repeated from 8 heads
    (``llama.repeat_kv``, as ``llama_forward`` hands them over), against
    ``mha_reference`` (1e-2 + 1e-2 |ref|); K4's cache part at W = 1, n_rep 4
    over one layer of a [32, S, 1, 8, 128] bf16 cache with the window's
    bias from ``llama._attention_bias``, at Mistral's 4096 (no key masked)
    and at 256 (it binds), against its plain version (``check_wwin_kernels``'
    tolerances).  Each timed in turns with the library's
    ``scaled_dot_product_attention`` (K4: with the boolean window mask over
    the layer's slice, k/v repeated), the plain version timed apart, the
    bound from the bytes each reads once (K4: the valid slots only) and its
    operations.  Returns {"flash_fwd": ..., "wwin_decode": ...}."""
    import torch

    from cullavo_tpu_torch.models.llava import llama
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import wwin_decode as ww

    sdpa_lib = torch.nn.functional.scaled_dot_product_attention   # a yardstick only
    bf = torch.bfloat16
    H, KV, hd, T = 32, 8, 128, BAK_PROMPT_T
    n_rep = H // KV
    out = {}
    q = torch.randn((1, T, H, hd), generator=g, device=device).to(bf).transpose(1, 2)
    k8, v8 = (torch.randn((1, T, KV, hd), generator=g, device=device).to(bf).transpose(1, 2)
              for _ in range(2))
    k, v = llama.repeat_kv(k8, n_rep), llama.repeat_kv(v8, n_rep)
    got = fa.flash_attention(q, k, v)
    ref = fa.mha_reference(q, k, v)
    torch.cuda.synchronize(device)
    err = (got.float() - ref.float()).abs().max().item()
    if not (torch.isfinite(got).all()
            and torch.allclose(got.float(), ref.float(), rtol=1e-2, atol=1e-2)):
        raise RuntimeError(f"K1 at BakLLaVA's prefill disagrees with mha_reference: {err}")
    med, turns, host = timed_turns({"kernel": lambda: fa.flash_attention(q, k, v),
                                    "library": lambda: sdpa_lib(q, k, v, is_causal=True)},
                                   device)
    plain = bench_ms(lambda: fa.mha_reference(q, k, v), device, reps=5)
    bd = bound(nbytes(q, k, v, got), 4 * H * hd * T * (T + 1) / 2, "bf16")
    log(f"K1 BakLLaVA prefill [1,{H},{T},{hd}] bf16 causal, k/v repeated from {KV} heads: "
        f"max_abs_err={err:.3e}, kernel {med['kernel']:.4f} ms, plain {plain:.4f} ms, library "
        f"sdpa {med['library']:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); in "
        f"turns {turns}; host us per call {host}")
    out["flash_fwd"] = dict(max_abs_err=err, ms=med["kernel"], plain_ms=plain,
                            library_ms=med["library"], **bd, times_in_turns=turns, host_us=host,
                            shape=f"q/k/v [1,{H},{T},{hd}] bf16 causal, k/v repeat_kv x{n_rep}")
    del q, k8, v8, k, v, got, ref

    L, S = 32, T + 16
    kc, vc = (torch.randn((L, S, 1, KV, hd), generator=g, device=device).to(bf)
              for _ in range(2))
    li, scale = L // 2, hd ** -0.5
    pos = torch.full((1, 1), S - 1, dtype=torch.int64, device=device)
    key_pos = torch.arange(S, device=device)[None]
    mask = torch.ones((1, S), dtype=torch.int32, device=device)
    mask[:, S - 1] = 0                                 # the fresh token's own slot
    forms = {}
    for window in (4096, BAK_CUT_WINDOW):
        q = torch.randn((1, 1, H, hd), generator=g, device=device).to(bf).transpose(1, 2)
        k_cur, v_cur = (torch.randn((1, H, 1, hd), generator=g, device=device).to(bf)
                        for _ in range(2))
        bias = llama._attention_bias(mask, pos, key_pos, window)        # [1, 1, 1, S]
        got = ww._run_cache_part(q, kc, vc, li, bias[:, 0], n_rep, scale)
        want = ww._cache_part_plain(q, kc, vc, li, bias[:, 0], n_rep, scale)
        o = ww.wwin_decode_smajor(q, kc, vc, li, k_cur, v_cur, bias, n_rep=n_rep)
        o_ref = ww._merge_self_window(q, k_cur, v_cur, *want, scale)
        torch.cuda.synchronize(device)
        (acc, m, l), (acc_r, m_r, l_r) = got, want
        excess = (acc - acc_r).abs() - 2e-3 * acc_r.abs() - 2.0 ** -8 * l_r[..., None]
        err = (o.float() - o_ref.float()).abs().max().item()
        if not ((excess <= 0).all() and torch.allclose(m, m_r, rtol=2e-3, atol=1e-3)
                and torch.allclose(l, l_r, rtol=2e-3, atol=1e-3)
                and torch.allclose(o.float(), o_ref.float(), rtol=1e-2, atol=1e-2)):
            raise RuntimeError(f"K4 at BakLLaVA's decode (window {window}) disagrees: {err}")
        visible = bias[0, 0, 0] == 0
        n_vis = int(visible.sum())
        kl, vl = kc[li].permute(1, 2, 0, 3), vc[li].permute(1, 2, 0, 3)   # [1, KV, S, hd]
        kr, vr = llama.repeat_kv(kl, n_rep), llama.repeat_kv(vl, n_rep)
        bmask = visible[None, None, None]
        med, turns, host = timed_turns({
            "kernel": lambda: ww._run_cache_part(q, kc, vc, li, bias[:, 0], n_rep, scale),
            "library": lambda: sdpa_lib(q, kr, vr, attn_mask=bmask)}, device)
        plain = bench_ms(lambda: ww._cache_part_plain(q, kc, vc, li, bias[:, 0], n_rep, scale),
                         device)
        bd = bound(2 * n_vis * KV * hd * 2 + nbytes(q, *got), 4 * H * n_vis * hd, "bf16")
        log(f"K4 BakLLaVA decode, window {window} ({n_vis} of {S} slots visible): W=1, n_rep "
            f"{n_rep}, one layer of [{L},{S},1,{KV},{hd}] bf16: max_abs_err={err:.3e}, kernel "
            f"{med['kernel']:.4f} ms, plain {plain:.4f} ms, library sdpa (boolean window mask, "
            f"k/v repeated) {med['library']:.4f} ms, bound {bd['bound_ms']:.6f} ms "
            f"({bd['bound_by']}); in turns {turns}; host us per call {host}")
        forms[f"window {window}"] = dict(max_abs_err=err, ms=med["kernel"], plain_ms=plain,
                                         library_ms=med["library"], **bd, visible_slots=n_vis,
                                         times_in_turns=turns, host_us=host)
    out["wwin_decode"] = dict(forms, shape=f"q [1,{H},1,{hd}], one layer of [{L},{S},1,{KV},"
                                            f"{hd}] bf16, n_rep {n_rep}, W=1")
    del kc, vc
    torch.cuda.empty_cache()
    return out


def check_int8_kernel(device, g):
    """Phase 3, K3: the int8 weight-only linear (the int8 instantiation of
    csrc/nf4_gemv_sm90.cu) at the paths' M: 8 (``vl_test``'s decode and the
    matmul probe), 14 (the greedy batch), 56 (the speculative windows) and
    5632 (``vl_test``'s prefill: 8 prompts of 704 tokens), at the three 7B
    shapes, with ``sq_inv`` (SmoothQuant dicts: the greedy and speculative
    batches) and without (``BITS: 8`` from a snapshot: ``vl_test``).  Within
    rtol 2^-7 + 1e-3 max|y| of the plain version (one bf16 ulp after an f32
    sum in another order); two calls bit-equal.  Timed per M and dict kind,
    summed over the three shapes, the card kept busy ahead of each timed call
    (host microseconds per call apart), beside the bound, the plain version,
    the eager composition ``(x * sq_inv) @ q8.to(bf16) * scale8`` (the
    record's library column) and a yardstick: the dense bf16
    ``torch.matmul`` on the weight dequantized beforehand (2x the bytes)."""
    import torch

    from cullavo_tpu_torch.ops import nf4

    bf = torch.bfloat16
    ms_by = {}
    worst = 0.0
    for K, N in NF4_SHAPES:
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        s = torch.exp(torch.randn((K,), generator=g, device=device) * 0.3)
        for kind in ("sq_inv", "no sq_inv"):
            q = nf4.quantize_linear_int8(w, smooth_scale=s if kind == "sq_inv" else None)
            dense = (q["q8"].float() * q["scale8"]).to(bf)
            for M in INT8_M:
                x = torch.randn((M, K), generator=g, device=device).to(bf)
                y = nf4.int8_linear(x, q)
                y2 = nf4.int8_linear(x, q)
                ref = nf4._int8_linear_plain(x, q)
                torch.cuda.synchronize(device)
                err = (y.float() - ref.float()).abs().max().item()
                top = ref.float().abs().max().item()
                ok = torch.allclose(y.float(), ref.float(), rtol=2 ** -7, atol=1e-3 * top)
                log(f"K3 int8_linear M={M} K={K} N={N} {kind}: max_abs_err={err:.3e} (max |y| "
                    f"{top:.3f}; tol one bf16 ulp + 1e-3 max|y|); two calls bit-equal: "
                    f"{torch.equal(y, y2)}")
                if not (ok and torch.isfinite(y).all() and torch.equal(y, y2)):
                    raise RuntimeError(f"K3 disagrees with its plain version at M={M} K={K} "
                                       f"N={N} ({kind}), or two calls differ")
                worst = max(worst, err)
                xs = x * q["sq_inv"] if kind == "sq_inv" else x
                fns = {"kernel": lambda: nf4.int8_linear(x, q),
                       "dense": lambda: xs @ dense,
                       "eager": lambda: (x * q["sq_inv"] if kind == "sq_inv" else x)
                       @ q["q8"].to(bf) * q["scale8"].to(bf)}
                med, _, host = timed_turns(fns, device, rounds=1)
                plain = bench_ms(lambda: nf4._int8_linear_plain(x, q), device, reps=5)
                t = ms_by.setdefault((M, kind), dict(ms=0.0, plain=0.0, dense=0.0, eager=0.0,
                                                    host=0.0, n_bytes=0, n_ops=0))
                t["ms"] += med["kernel"]
                t["dense"] += med["dense"]
                t["eager"] += med["eager"]
                t["plain"] += plain
                t["host"] += host["kernel"]
                t["n_bytes"] += nbytes(x, q["q8"], q["scale8"], y,
                                       *((q["sq_inv"],) if kind == "sq_inv" else ()))
                t["n_ops"] += 2 * M * K * N
                log(f"K3 M={M} K={K} N={N} {kind}: kernel {med['kernel']:.4f} ms, dense bf16 "
                    f"{med['dense']:.4f} ms, eager {med['eager']:.4f} ms, plain {plain:.4f} ms; "
                    f"host us per call {host}")
                del x, y, y2, ref
            del q, dense
        del w
    rec = {}
    for (M, kind), t in ms_by.items():
        bd = bound(t["n_bytes"], t["n_ops"], "bf16")
        log(f"K3 sum of the three shapes at M={M} ({kind}): kernel {t['ms']:.4f} ms, dense bf16 "
            f"matmul (yardstick) {t['dense']:.4f} ms, eager composition {t['eager']:.4f} ms, "
            f"plain {t['plain']:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
            f"{t['n_bytes'] / 1e6:.1f} MB), host us per call {t['host'] / 3:.1f} (mean of three)")
        times = dict(ms=t["ms"], plain_ms=t["plain"], library_ms=t["eager"],
                     dense_bf16_ms=t["dense"], host_us=round(t["host"] / 3, 1), **bd,
                     shape=f"M={M}, {kind}, (K,N) in (4096,4096),(4096,11008),(11008,4096), "
                           "ms summed over the three")
        if (M, kind) == (BATCH, "sq_inv"):   # the greedy batch's decode
            rec["int8_linear"] = {**times, **rec.get("int8_linear", {})}
        else:
            rec.setdefault("int8_linear", {}).setdefault("other_shapes", {})[
                f"M={M} {kind}"] = times
    rec["int8_linear"]["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return rec


# flash_fwd_sm90_kernel<kLse, kMasked>: each instantiation by its mangled
# template arguments, and the kernel-line names of the forms it serves
# the Hopper templates' instantiations: mangled-name key -> (label, the
# records they serve, source)
_FLASH_SRC, _GEMV_SRC = "csrc/flash_fwd_sm90.cu", "csrc/nf4_gemv_sm90.cu"
_DECODE_SRC, _WWIN_SRC = "csrc/flash_decode.cu", "csrc/wwin_decode_sm90.cu"
_BF = "13__nv_bfloat16"
SM90_FORMS = {"flash_fwd_sm90_kernelILb0ELb0E": ("K1 / K13", ("flash_fwd", "flash_packed"),
                                                 _FLASH_SRC),
              "flash_fwd_sm90_kernelILb1ELb0E": ("K1-lse", ("flash_fwd_lse",), _FLASH_SRC),
              "flash_fwd_sm90_kernelILb0ELb1E": ("K8", ("flash_rows",), _FLASH_SRC),
              "flash_fwd_sm90_kernelILb1ELb1E": ("K8-lse", ("flash_rows",), _FLASH_SRC),
              **{f"nf4_gemv_kernelILi{f}ELi{nt}ELi{g}E": (f"{k} NT={nt} G={g}", (rec,), _GEMV_SRC)
                 for f, k, rec in ((0, "K6", "nf4_linear_planar"), (1, "K11", "nf4_linear_q4"))
                 for nt in (16, 32, 64) for g in (1, 2, 4)},
              **{f"nf4_gemv_kernelILi2ELi{nt}ELi{g}E": (f"K3 NT={nt} G={g}", ("int8_linear",),
                                                        _GEMV_SRC)
                 for nt in (16, 32, 64, 128, 256) for g in (1, 2)},
              **{f"nf4_gemv_kernelILi3ELi{nt}ELi{g}E": (f"K14 NT={nt} G={g}", ("p32_linear",),
                                                        _GEMV_SRC)
                 for nt in (16, 32, 64) for g in (1, 2, 4)},
              # K10 by dtype and slots a thread (csrc/focal_ctx.cu)
              **{f"focal_kernelI{t}Li{ns}E": (f"K10 {n} {ns} slots a thread", ("focal_ctx",),
                                              "csrc/focal_ctx.cu")
                 for t, n in (("f", "f32"), (_BF, "bf16")) for ns in (1, 2, 3)},
              # the decode bodies (csrc/decode_rows.cuh's lane-group body by
              # cache type, rows a block and mode; the W-window mma body by
              # row tiles a block and cache type)
              **{f"rows_kernelI{t}Li{nr}ELi0E": (f"K12 {n} {nr} heads a block", ("flash_decode",),
                                                 _DECODE_SRC)
                 for t, n in (("f", "f32"), (_BF, "bf16")) for nr in (1, 2, 4)},
              f"rows_kernelI{_BF}Li1ELi1E": ("K4 R=1", ("wwin_decode",), _WWIN_SRC),
              "rows_kernelIaLi1ELi1E": ("K5 R=1", ("wwin_decode_q8",), _WWIN_SRC),
              **{f"wwin_mma_kernelILi{wr}ELb{q}E": (f"{k} R>1 WR={wr}", (rec,), _WWIN_SRC)
                 for q, k, rec in ((0, "K4", "wwin_decode"), (1, "K5", "wwin_decode_q8"))
                 for wr in (1, 2, 4)},
              # K9 by dtype, head dim and body (3 levels x 4 points, or counts
              # at run time); K2 by vectors a thread and multiplier
              **{f"msdeform_kernelI{t}Li{hd}ELi{lp}ELi{pp}E":
                 (f"K9 {n} hd {hd} {'3x4' if lp else 'generic'}", ("ms_deform_attn",),
                  "csrc/msdeform.cu")
                 for t, n in (("f", "f32"), (_BF, "bf16")) for hd in (32, 64, 128)
                 for lp, pp in ((3, 4), (0, 0))},
              **{f"quant_rows_kernelILi{v}ELi{mk}E": (f"K2 VPT={v} {m}", ("quant_rows",),
                                                      "csrc/quant_rows.cu")
                 for v in (2, 4, 6, 8) for mk, m in ((0, "no mult"), (1, "bf16"), (2, "f32"))}}


def sm90_report():
    """The ptxas report of every instantiation of the Hopper templates (the
    forward flash kernel, csrc/flash_fwd_sm90.cu: K1 / K13, K1-lse, K8,
    K8-lse; the fused weight-only linears, csrc/nf4_gemv_sm90.cu: K6, K11
    and K3 at each token tile; the decode bodies: K12, K4 and K5):
    registers, spill stores and loads, and any wgmma serialization warning
    (C75xx: C7513 where registers that feed a wgmma are written while one is
    in flight), from this process's build; keyed by ``SM90_FORMS``'s labels."""
    from cullavo_tpu_torch import _build

    def label_of(line):
        return next((label for key, (label, _, _) in SM90_FORMS.items() if key in line), None)

    rows, name, warned = {}, None, {}
    for line in _build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:
            name = label_of(line)
            if name:
                rows[name] = {"warnings": []}
        elif "C75" in line and label_of(line):
            # a wgmma warning names its function and comes before its entry
            warned.setdefault(label_of(line), []).append(line.split(" : ")[-1])
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split() if w.isdigit()]
            rows[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                              spill_load_bytes=nums[2])
        elif name and "Used" in line and "registers" in line:
            rows[name]["registers"] = int(line.split("Used")[1].split()[0])
    for label, lines in warned.items():
        if label in rows:
            rows[label]["warnings"] = [w.split(" in the function")[0] for w in lines]
    return rows


def bench_turns(fns, device, rounds=2, reps=20, lead_cycles=0):
    """Each of ``fns`` timed by ``bench_ms`` in turns, ``rounds`` times over
    (kernel, yardsticks, kernel, ...): name -> list of medians."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(bench_ms(fn, device, reps=reps, lead_cycles=lead_cycles))
    return times


def host_us(fn, device, n=50):
    """Host microseconds per call of ``fn`` (what the caller's thread spends
    checking and launching), over ``n`` calls queued without a sync."""
    import torch

    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize(device)
    return (t1 - t0) / n * 1e6


def timed_turns(fns, device, rounds=3):
    """Each of ``fns`` timed in turns (``rounds`` rounds), the card kept busy
    ~0.5 ms ahead of each timed call so that the events time the card alone;
    host microseconds per call measured apart.  Returns (median ms by name,
    the rounds' medians by name, host us by name)."""
    t = bench_turns(fns, device, rounds=rounds, lead_cycles=1_000_000)
    return ({n: statistics.median(x) for n, x in t.items()},
            {n: [round(y, 4) for y in x] for n, x in t.items()},
            {n: round(host_us(fn, device), 1) for n, fn in fns.items()})


def check_flash_sm90(device, g):
    """Phase 3, K1 and K1-lse (csrc/flash_fwd_sm90.cu, TMA + wgmma) against
    ``mha_reference``: o within 1e-2 + 1e-2 |ref| (P and O round to bf16 at
    other places), the f32 lse within 2e-3, K1-lse's o bit-equal to K1's and
    a second launch bit-equal to the first.  Held at the edge values of T
    (1, 64, 127, 128, 129, 200: a single row, one tile, the ragged tiles
    either side of it), on strided head views of [B, T, H, d] and on
    contiguous [B, H, T, d] tensors, and at the main paths' shapes: K1 at
    the greedy prefill's [2 | 7, 32, 648, 128], K1-lse at the train step's
    [8, 32, 1024, 128] and the training loop's [8, 32, 1929, 128].  Timed at
    those shapes in turns with ``scaled_dot_product_attention(is_causal=True)``
    (a yardstick the port never calls) and K13 (the same kernel, behind maps
    its entry encodes) on the same bytes seen as the packed [B, T, H*d]
    layout, the card kept busy
    ahead of each timed call so that the events see its time alone (each
    call's host time is measured apart); the plain version once; bounds from
    this run's inputs (causal pairs T (T + 1) / 2)."""
    import torch

    from cullavo_tpu_torch.ops import flash_attention as fa

    bf, d = torch.bfloat16, 128
    sdpa_lib = torch.nn.functional.scaled_dot_product_attention   # a yardstick only
    rec = {}

    def qkv(B, H, T, strided=True):
        if strided:
            return [torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2)
                    for _ in range(3)]
        return [torch.randn((B, H, T, d), generator=g, device=device).to(bf) for _ in range(3)]

    def hold(label, q, k, v):
        o1 = fa.flash_attention(q, k, v)
        o, lse = fa._flash_cuda(q, k, v, None, None, True, True)
        again = fa._flash_cuda(q, k, v, None, None, True, True)
        o_ref, lse_ref = fa.mha_reference(q, k, v, need_lse=True)
        torch.cuda.synchronize(device)
        err = (o.float() - o_ref.float()).abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        log(f"K1/K1-lse {label}: o max_abs_err={err:.3e} (tol 1e-2 + 1e-2 |ref|), lse "
            f"max_abs_err={lerr:.3e} (f32, tol 2e-3); K1-lse o == K1 o: "
            f"{torch.equal(o, o1)}; second launch equal: {torch.equal(o, again[0])}")
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()
                and torch.allclose(o.float(), o_ref.float(), rtol=1e-2, atol=1e-2)
                and torch.allclose(lse, lse_ref, rtol=1e-5, atol=2e-3)):
            raise RuntimeError(f"K1/K1-lse disagree with mha_reference at {label}: {err}, "
                               f"lse {lerr}")
        if not (torch.equal(o, o1) and torch.equal(o, again[0])
                and torch.equal(lse, again[1])):
            raise RuntimeError(f"K1/K1-lse at {label}: outputs not bit-equal across the forms "
                               "or across launches")
        return err, (o, lse)

    for T in (1, 64, 127, 128, 129, 200):
        for strided in (True, False):
            hold(f"B=2 H=8 T={T} {'strided' if strided else 'contiguous'}",
                 *qkv(2, 8, T, strided))
    # a head axis broadcast by expand (stride 0), as tensor-map extent 1
    q = qkv(2, 8, 300)[0]
    kb, vb = (torch.randn((2, 1, 300, d), generator=g, device=device).to(bf)
              .expand(2, 8, 300, d) for _ in range(2))
    hold("B=2 H=8 T=300 k/v expanded over heads", q, kb, vb)

    T_pre = PAD_TO * -(-(1 + 576 + PROMPT_TEXT) // PAD_TO)
    for name, B, T in (("flash_fwd", 2, T_pre), ("flash_fwd", CHUNK, T_pre),
                       ("flash_fwd_lse", TRAIN_CFG["BATCH_SIZE"], TRAIN_T),
                       ("flash_fwd_lse", TRAIN_CFG["BATCH_SIZE"], 1929)):
        H = 32
        q, k, v = qkv(B, H, T)
        err, got = hold(f"B={B} H={H} T={T} strided", q, k, v)
        if B == 2:
            continue
        lse_form = name == "flash_fwd_lse"
        packed = [t.transpose(1, 2).reshape(B, T, H * d) for t in (q, k, v)]   # views
        fns = {"kernel": (lambda: fa._flash_cuda(q, k, v, None, None, True, True)) if lse_form
               else (lambda: fa.flash_attention(q, k, v)),
               "library": lambda: sdpa_lib(q, k, v, is_causal=True),
               "k13": lambda: fa.flash_attention_packed(*packed, H)}
        if lse_form:
            fns["k1"] = lambda: fa.flash_attention(q, k, v)
        # ~0.5 ms of card time ahead of each timed call: the events time the
        # card, not the wrapper's host work (timed apart, per call)
        t = bench_turns(fns, device, rounds=3, lead_cycles=1_000_000)
        host = {n: host_us(fn, device) for n, fn in fns.items()}
        plain = bench_ms(lambda: fa.mha_reference(q, k, v, need_lse=lse_form), device, reps=5)
        ms, lib, k13 = (statistics.median(t[n]) for n in ("kernel", "library", "k13"))
        bd = bound(nbytes(q, k, v, *got) if lse_form else nbytes(q, k, v, got[0]),
                   4 * B * H * d * T * (T + 1) / 2, "bf16")
        spread = {n: [round(x, 4) for x in v_] for n, v_ in t.items()}
        log(f"{'K1-lse' if lse_form else 'K1'} [{B},{H},{T},{d}]: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, library sdpa {lib:.4f} ms, K13 (packed view) "
            f"{k13:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); in turns {spread}; "
            f"host us per call {({n: round(x, 1) for n, x in host.items()})}")
        if lse_form:
            k1 = statistics.median(t["k1"])
            log(f"K1-lse / K1 at [{B},{H},{T},{d}]: {ms / k1:.3f} ({ms:.4f} / {k1:.4f} ms)")
        if name == "flash_fwd" or T == TRAIN_T:
            rec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **bd,
                             k13_same_inputs_ms=k13, times_in_turns=spread, host_us=host,
                             shape=f"q/k/v [{B},{H},{T},{d}] bf16 causal"
                                   + (" + lse f32" if lse_form else ""))
        else:
            rec[name]["loop_shape"] = dict(T=T, ms=ms, plain_ms=plain, library_ms=lib,
                                           k13_same_inputs_ms=k13, **bd)
        del q, k, v, packed, got, fns
        torch.cuda.empty_cache()
    return rec


def check_train_kernels(device, g):
    """Phase 3, the training kernels: K8 against ``mha_reference`` (o within
    1e-2 + 1e-2 |ref|: P and O round to bf16 at other places; the f32 lse
    within 2e-3), the autograd function's gradients against autograd
    through the plain version, the chunked backward's time at the train
    shape, and ``nf4_linear_planar_vjp``'s dx against the dense matmul.
    K1-lse is held in ``check_flash_sm90``."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import dropout_mask
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.ops import nf4

    bf = torch.bfloat16
    sdpa_lib = torch.nn.functional.scaled_dot_product_attention   # a yardstick only
    rec = {}

    def qkv(B, H, T, S, d):
        return (torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2),
                *(torch.randn((B, S, H, d), generator=g, device=device).to(bf).transpose(1, 2)
                  for _ in range(2)))

    def hold(name, got, want):
        (o, lse), (o_ref, lse_ref) = got, want
        torch.cuda.synchronize(device)
        err = (o.float() - o_ref.float()).abs().max().item()
        lerr = (lse - lse_ref).abs().max().item()
        log(f"{name}: o max_abs_err={err:.3e} (tol 1e-2 + 1e-2 |ref|), lse max_abs_err="
            f"{lerr:.3e} (f32, tol 2e-3)")
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()
                and torch.allclose(o.float(), o_ref.float(), rtol=1e-2, atol=1e-2)
                and torch.allclose(lse, lse_ref, rtol=1e-5, atol=2e-3)):
            raise RuntimeError(f"{name} disagrees with mha_reference: {err}, lse {lerr}")
        return err

    # K1-lse's o and lse at the train shape (held and timed in
    # check_flash_sm90) feed the backward's timing
    B, H, T, d = TRAIN_CFG["BATCH_SIZE"], 32, TRAIN_T, 128
    q, k, v = qkv(B, H, T, T, d)
    got = fa._flash_cuda(q, k, v, None, None, True, True)
    flops = 4 * B * H * T * T * d / 2

    # the backward of the autograd function at the train shape (plain
    # PyTorch in the port, as it is plain XLA in the JAX package)
    o, lse = got
    do = torch.randn((B, T, H, d), generator=g, device=device).to(bf).transpose(1, 2)
    bwd_ms = bench_ms(lambda: fa._flash_bwd(q, k, v, None, None, True, o, lse, do), device,
                      reps=5)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))
    lib_out = sdpa_lib(ql, kl, vl, is_causal=True)
    lib_bwd = bench_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do, retain_graph=True),
                       device, reps=5)
    plain_out = fa.mha_reference(ql, kl, vl)
    plain_bwd = bench_ms(lambda: torch.autograd.grad(plain_out, (ql, kl, vl), do,
                                                     retain_graph=True), device, reps=5)
    bd = bound(nbytes(q, k, v, o, lse, do, q, k, v), 2.5 * flops, "bf16")
    log(f"flash backward (chunked PyTorch) B={B} T={T}: {bwd_ms:.4f} ms, autograd through the "
        f"plain version {plain_bwd:.4f} ms, library sdpa backward {lib_bwd:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
    del ql, kl, vl, lib_out, plain_out, o, lse, do, got
    torch.cuda.empty_cache()

    # K8 at the probe shape: right padding (timed), left padding, S > T, non-causal
    B, H, T, d = PROBE_SHAPE
    for label, Tq, S, causal, left in (("right-padded", T, T, True, False),
                                       ("left-padded", T, T, True, True),
                                       ("S > T", 200, T, True, False),
                                       ("non-causal", T, T, False, False)):
        q, k, v = qkv(B, H, Tq, S, d)
        idx = torch.arange(S, device=device)[None, :].expand(B, S)
        valid = ((idx >= 7) if left else (idx < S - 7)).int()
        pos = (torch.cumsum(valid, dim=1) - 1).clamp_min(0)[:, S - Tq:].int()
        if left:   # key j sits at index j; the padded queries see no key
            pos = torch.where(valid[:, S - Tq:] != 0, idx[:, S - Tq:], -1).int()
        got = fa._flash_cuda(q, k, v, pos, valid, causal, True)
        o_only = fa._flash_cuda(q, k, v, pos, valid, causal, False)
        want = fa.mha_reference(q, k, v, causal, pos, valid, need_lse=True)
        err = hold(f"K8 flash_rows {label} B={B} H={H} T={Tq} S={S}", got, want)
        if not torch.equal(o_only, got[0]):
            raise RuntimeError(f"K8 {label}: the o-only form differs from the lse form")
        if left and not ((got[1][:, :, :7] <= -1e29).all() and torch.allclose(
                got[0][:, :, :7].float(), v.float().mean(dim=2, keepdim=True).expand(
                    B, H, 7, d), atol=2e-2)):
            raise RuntimeError("K8: a wholly masked row is not the mean of v")
        if label != "right-padded":
            continue
        visible = (pos[:, :, None] >= idx[:, None, :]) & (valid != 0)[:, None, :]
        # K8-lse in turns with the library (boolean mask) and K1-lse on the
        # same bytes (the causal work without masks), the card kept busy
        # ahead of each timed call; host time per call measured apart
        fns = {"kernel": lambda: fa._flash_cuda(q, k, v, pos, valid, causal, True),
               "library": lambda: sdpa_lib(q, k, v, attn_mask=visible[:, None]),
               "k1_lse": lambda: fa._flash_cuda(q, k, v, None, None, True, True)}
        t = bench_turns(fns, device, rounds=3, lead_cycles=1_000_000)
        host = {n: host_us(fn, device) for n, fn in fns.items()}
        host["int32_masks"] = host_us(
            lambda: [m.to(torch.int32).contiguous() for m in (pos, valid)], device)
        plain = bench_ms(lambda: fa.mha_reference(q, k, v, causal, pos, valid, need_lse=True),
                         device, reps=5)
        ms, lib, k1 = (statistics.median(t[n]) for n in ("kernel", "library", "k1_lse"))
        # rows with no visible key need every key (p = 1): there are none here
        n_pairs = int(visible.sum().item())
        bd = bound(nbytes(q, k, v, *got, pos, valid), 4 * H * n_pairs * d, "bf16")
        spread = {n: [round(x, 4) for x in v_] for n, v_ in t.items()}
        log(f"K8 B={B} T={Tq}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library sdpa (boolean "
            f"mask) {lib:.4f} ms, K1-lse on the same bytes {k1:.4f} ms (K8 / K1-lse "
            f"{ms / k1:.3f}), bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, {n_pairs} "
            f"visible pairs of {B * Tq * S}); in turns {spread}; host us per call "
            f"{({n: round(x, 1) for n, x in host.items()})}")
        rec["flash_rows"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, library_ms=lib, **bd,
                                 k1_same_inputs_ms=k1, times_in_turns=spread, host_us=host,
                                 shape=f"q/k/v [{B},{H},{Tq},{d}] bf16, qpos [{B},{Tq}], "
                                       f"kvalid [{B},{S}], causal + lse f32")
        del fns

    # dq, dk, dv of the autograd function against autograd through the plain version
    for label, masked in (("bias-free (K1-lse)", False), ("masked (K8)", True)):
        q, k, v = qkv(2, 8, 520, 520, d)
        do = torch.randn((2, 8, 520, d), generator=g, device=device).to(bf)
        idx = torch.arange(520, device=device)[None, :].expand(2, 520)
        valid = (idx >= 7).int() if masked else None
        pos = torch.where(valid != 0, idx, -1).int() if masked else None
        grads = []
        for fn in (fa.flash_attention, fa.mha_reference):
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            out = (fn(*leaves, pos, valid, True) if fn is fa.flash_attention
                   else fn(*leaves, True, pos, valid))
            grads.append(torch.autograd.grad(out, leaves, do))
        torch.cuda.synchronize(device)
        for name, a, b in zip(("dq", "dk", "dv"), *grads):
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            log(f"flash backward {label} {name}: max_abs_err={err:.3e}, max |ref| {top:.3f} "
                "(tol 2e-2 of the largest entry: P, dS and dO round to bf16)")
            if not (torch.isfinite(a).all() and err <= 2e-2 * top):
                raise RuntimeError(f"flash backward {label}: {name} disagrees: {err}")
        if masked and (grads[0][0][:, :, :7].any() or grads[0][1][:, :, :7].any()):
            raise RuntimeError("flash backward: a masked row or key got a gradient")

    # nf4_linear_planar_vjp: dx = dy.bf16 @ K7(q).T against the dense matmul
    M = TRAIN_CFG["BATCH_SIZE"] * TRAIN_T
    vjp = dict(ms=0.0, dense=0.0, n_bytes=0, n_ops=0)
    for K, N in NF4_SHAPES:
        qw = nf4.quantize_linear_planar(torch.randn((K, N), generator=g, device=device)
                                        * K ** -0.5)
        x = torch.randn((M, K), generator=g, device=device).to(bf).requires_grad_(True)
        dy = torch.randn((M, N), generator=g, device=device).to(bf)
        y = nf4.nf4_linear_planar_vjp(x, qw)
        dx, = torch.autograd.grad(y, x, dy, retain_graph=True)
        w = nf4.dequant_linear_planar(qw)
        ref = (dy.float() @ w.float().T)
        torch.cuda.synchronize(device)
        err = (dx.float() - ref).abs().max().item()
        log(f"nf4_linear_planar_vjp dx M={M} K={K} N={N}: max_abs_err={err:.3e}, max |dx| "
            f"{ref.abs().max().item():.3f} (tol 1e-2 + 1e-2 |ref|: one bf16 rounding)")
        if not torch.allclose(dx.float(), ref, rtol=1e-2, atol=1e-2):
            raise RuntimeError(f"nf4_linear_planar_vjp: dx disagrees at K={K} N={N}: {err}")
        vjp["ms"] += bench_ms(lambda: torch.autograd.grad(y, x, dy, retain_graph=True), device,
                              reps=5)
        vjp["dense"] += bench_ms(lambda: dy @ w.T, device, reps=5)
        vjp["n_bytes"] += nbytes(dy, qw["q4p"], qw["scale"], dx)
        vjp["n_ops"] += 2 * M * K * N
        del qw, x, dy, y, dx, w, ref
    bd = bound(vjp["n_bytes"], vjp["n_ops"], "bf16")
    log(f"nf4_linear_planar_vjp backward, sum of the three shapes at M={M}: K7 + matmul "
        f"{vjp['ms']:.4f} ms, the dense bf16 matmul alone {vjp['dense']:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")

    # what a rematerialized layer pays again for its adapters: the seven
    # u = x @ a products (the JAX remat policy saves u) and the dropout masks
    u_ms, mask_ms = 0.0, 0.0
    for K, n_targets in ((4096, 6), (11008, 1)):     # q k v o gate up; down
        x = torch.randn((M, K), generator=g, device=device).to(bf)
        a = torch.randn((K, 64), generator=g, device=device).to(bf)
        u_ms += n_targets * bench_ms(lambda: x @ a, device, reps=5)
        mask_ms += n_targets * bench_ms(lambda: dropout_mask(x, 0.05, 1), device, reps=5)
    log(f"one layer's adapters at M={M}, r=64: the seven x @ a products {u_ms:.4f} ms, the "
        f"seven dropout masks {mask_ms:.4f} ms (both run again in the rematerialized backward)")
    torch.cuda.empty_cache()
    return rec


def msdeform_grid_sample(value, shapes, loc, att):
    """The reference's PyTorch composition of multi-scale deformable
    attention (one ``grid_sample`` per level, then the weighted sum): a
    yardstick timed here only, the port never calls it."""
    import torch
    import torch.nn.functional as F

    B, S, Hh, hd = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = (2 * loc - 1).to(value.dtype)
    sampled, start = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, start:start + h * w].flatten(2).transpose(1, 2).reshape(B * Hh, hd, h, w)
        start += h * w
        sampled.append(F.grid_sample(v, grids[:, :, :, lvl].transpose(1, 2).flatten(0, 1),
                                     mode="bilinear", padding_mode="zeros", align_corners=False))
    a = att.transpose(1, 2).reshape(B * Hh, 1, Q, L * P)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * a).sum(-1)
    return out.view(B, Hh * hd, Q).transpose(1, 2)


def focal_chain_cudnn(ctx, gates, level_weights, H, W, kernels):
    """The FocalNet model's own chain in the working dtype: cuDNN's
    depthwise ``conv2d(groups=C)``, tanh GELU, gates, the global term, the
    scaling (what JAX's XLA branch computes at bf16): a yardstick timed
    here only, the port never calls it."""
    import torch
    import torch.nn.functional as F

    B, C, _ = ctx.shape
    L = len(kernels)
    x = ctx.reshape(B, C, H, W)
    g = gates.reshape(B, L + 1, H, W)
    acc = torch.zeros_like(x)
    for lvl, w in enumerate(level_weights):
        x = F.gelu(F.conv2d(x, w, padding=w.shape[-1] // 2, groups=C), approximate="tanh")
        acc = acc + x * g[:, lvl:lvl + 1]
    acc = acc + F.gelu(x.mean((2, 3), keepdim=True), approximate="tanh") * g[:, L:L + 1]
    return (acc / (L + 1)).reshape(B, C, H * W)


def check_xdecoder_kernels(device, g):
    """Phase 3, the X-Decoder kernels.  K9 (multi-scale deformable
    attention) at the deformable encoder's shape at a 512^2 image (B 8, S = Q
    = 64^2 + 32^2 + 16^2, 8 heads x 64, 3 levels x 4 points), at the 512 x 640
    bucket's non-square levels and at a Q that fills no tile; points drawn
    in [-0.1, 1.1] (some outside every map, draw u), and at the encoder's
    own draw p (the locations and weights one layer of the seeded encoder
    builds: each point a few pixels from its query's pixel centre); timed
    card alone at both draws (``flash_bench.deform_draws``, the inputs
    ``flash_bench.py --forms deform`` times).  K10 (the gated focal context)
    at each FocalNet-L stage map of the 512^2 and 512 x 640 buckets and of
    the VLP eval's 224^2 (stage 4 is 7 x 7, under the 9 x 9 level), batch 8,
    both GELU forms; timed per 512^2 and 224^2 stage with the card kept
    busy ahead of each timed call (host us per call apart), then per
    forward.
    Both within 1e-2 + 1e-2 |ref| of the plain version in bf16 (one
    rounding of the output) and within 1e-5 + 1e-5 |ref| in f32 (sums in
    another order: the plain focal chain runs on cuDNN)."""
    import torch

    from cullavo_tpu_torch.models.xdecoder.focalnet import FocalNetConfig
    from cullavo_tpu_torch.ops import focal, msdeform
    from cullavo_tpu_torch.scripts.flash_bench import deform_draws

    bf, f32 = torch.bfloat16, torch.float32
    rec = {}

    def hold(name, got, ref, dtype):
        torch.cuda.synchronize(device)
        err = (got.float() - ref.float()).abs().max().item()
        tol = (1e-5, 1e-5) if dtype == f32 else (1e-2, 1e-2)
        log(f"{name}: max_abs_err={err:.3e} (tol {tol[0]:g} + {tol[1]:g} |ref|)")
        if not (got.dtype == dtype and torch.isfinite(got).all()
                and torch.allclose(got.float(), ref.float(), atol=tol[0], rtol=tol[1])):
            raise RuntimeError(f"{name} disagrees with its plain version: {err}")
        return err

    # K9
    side = XDEC_SIDE // 8
    path_shapes = ((side // 4, side // 4), (side // 2, side // 2), (side, side))
    bucket_shapes = ((16, 20), (32, 40), (64, 80))
    Hh, hd, P = 8, 64, 4

    def deform_case(shapes, B, Q, dtype):
        S, L = sum(h * w for h, w in shapes), len(shapes)
        value = torch.randn((B, S, Hh, hd), generator=g, device=device).to(dtype)
        loc = torch.rand((B, Q, Hh, L, P, 2), generator=g, device=device) * 1.2 - 0.1
        att = torch.softmax(torch.randn((B, Q, Hh, L * P), generator=g, device=device), -1)
        return value, loc, att.reshape(B, Q, Hh, L, P).to(dtype)

    errs = []
    S_path = sum(h * w for h, w in path_shapes)
    for shapes, B, Q in ((path_shapes, XDEC_BATCH, S_path), (bucket_shapes, 2, 6720),
                         (path_shapes, 2, 3001)):
        for dtype in (bf, f32):
            value, loc, att = deform_case(shapes, B, Q, dtype)
            got = msdeform.ms_deform_attn_kernel(value, shapes, loc, att)
            ref = msdeform.ms_deform_attn(value, shapes, loc, att)
            errs.append(hold(f"K9 ms_deform_attn levels {shapes} B={B} Q={Q} {dtype}", got, ref,
                             dtype))
            if dtype == f32 and Q == S_path:
                lib_out = msdeform_grid_sample(value, shapes, loc, att)
                if not torch.allclose(lib_out, ref, atol=1e-4, rtol=1e-4):
                    raise RuntimeError("the grid_sample yardstick disagrees with the plain version")
    # the encoder's own draw (p): what one layer of the seeded encoder hands
    # K9; then both draws timed card alone (the same inputs as flash_bench.py)
    for dtype in (bf, f32):
        value, shapes, loc, att = deform_draws(torch, device, XDEC_BATCH, dtype)["p"]
        got = msdeform.ms_deform_attn_kernel(value, shapes, loc, att)
        ref = msdeform.ms_deform_attn(value, shapes, loc, att)
        errs.append(hold(f"K9 ms_deform_attn levels {shapes} B={XDEC_BATCH} Q={S_path} {dtype} "
                         "draw p", got, ref, dtype))
    draws = deform_draws(torch, device, XDEC_BATCH)
    timed, host = {}, {}
    for d, (value, shapes, loc, att) in draws.items():
        run = (lambda a=(value, shapes, loc, att): msdeform.ms_deform_attn_kernel(*a))
        timed[d] = bench_turns({"kernel": run}, device, rounds=3, lead_cycles=1_000_000)["kernel"]
        host[d] = round(host_us(run, device), 1)
    value, shapes, loc, att = draws["u"]
    out = msdeform.ms_deform_attn_kernel(value, shapes, loc, att)
    ms = statistics.median(timed["u"])
    plain = bench_ms(lambda: msdeform.ms_deform_attn(value, shapes, loc, att), device)
    lib = bench_ms(lambda: msdeform_grid_sample(value, shapes, loc, att), device,
                   lead_cycles=1_000_000)
    # the least work: per sampling point and channel 4 corner multiply-adds,
    # the attention weight folded into the corner weights (f32)
    points = XDEC_BATCH * S_path * Hh * len(path_shapes) * P
    bd = bound(nbytes(value, loc, att, out), 2 * 4 * hd * points, "f32")
    log(f"K9 B={XDEC_BATCH} Q=S={S_path}: kernel card alone draw u {ms:.4f} ms (rounds "
        f"{[round(v, 4) for v in timed['u']]}), draw p {statistics.median(timed['p']):.4f} ms "
        f"(rounds {[round(v, 4) for v in timed['p']]}), host {host} us per call; plain "
        f"{plain:.4f} ms, grid_sample yardstick {lib:.4f} ms, bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}, {nbytes(value, loc, att, out) / 1e6:.1f} MB)")
    rec["ms_deform_attn"] = dict(
        max_abs_err=max(errs), ms=ms, plain_ms=plain, library_ms=lib, **bd, host_us=host,
        other_shapes={"draw p": dict(ms=statistics.median(timed["p"]))},
        shape=f"value [{XDEC_BATCH},{S_path},{Hh},{hd}] bf16, levels {path_shapes}, "
              f"loc [{XDEC_BATCH},{S_path},{Hh},3,{P},2] f32, att bf16, draw u (uniform "
              "points); one launch (6 per forward); library_ms: one grid_sample per level + "
              "weighted sum")

    # K10: one launch per FocalNet-L block, stage by stage
    fcfg = FocalNetConfig()
    kernels = tuple(fcfg.focal_factor * lvl + fcfg.focal_windows[0]
                    for lvl in range(fcfg.focal_levels[0]))
    L = len(kernels)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    errs = []

    def focal_case(C, h, w, dtype):
        fx = torch.randn((XDEC_BATCH, 2 * C + L + 1, h * w), generator=g,
                         device=device).to(dtype)
        # taps of std 0.6 / k: every level's output stays of order one
        taps = torch.cat([torch.randn((C, k * k), generator=g, device=device) * (0.6 / k)
                          for k in kernels], dim=1)
        return fx[:, C:2 * C], fx[:, 2 * C:], taps       # views, as focal_modulation passes

    def focal_hold(i, C, h, w):
        """K10 against the plain version at one map, f32 and bf16, both
        GELU forms; returns the bf16 inputs and an output."""
        plan = focal.focal_plan(h, w, C, kernels, focal.FOCAL_SMEM, XDEC_BATCH, sms)
        for dtype in (f32, bf):
            ctx, gates, taps = focal_case(C, h, w, dtype)
            for approximate in (True, False):
                got = focal.focal_ctx_kernel(ctx, gates, taps, h, w, kernels, True, approximate)
                ref = focal.focal_ctx_plain(ctx, gates, taps, h, w, kernels, True, approximate)
                errs.append(hold(f"K10 focal_ctx stage {i + 1} [{XDEC_BATCH},{C},{h}x{w}] "
                                 f"{dtype} {'tanh' if approximate else 'erf'} ({plan['path']}"
                                 f", {plan['planes']} planes a block)", got, ref, dtype))
        return ctx, gates, taps, got

    def focal_time(label, C, s, ctx, gates, taps, got, host):
        """K10 card alone (host us apart), the plain version and the cuDNN
        chain at an s x s map in bf16; (record, bytes, operations)."""
        cols = [sum(kk * kk for kk in kernels[:j]) for j in range(L + 1)]
        weights = [taps[:, cols[j]:cols[j + 1]].to(bf).reshape(C, 1, k, k)
                   for j, k in enumerate(kernels)]

        def run():
            return focal.focal_ctx_kernel(ctx, gates, taps, s, s, kernels, True, True)

        ms = bench_ms(run, device, lead_cycles=1_000_000)
        host[label] = round(host_us(run, device), 1)
        plain = bench_ms(lambda: focal.focal_ctx_plain(ctx, gates, taps, s, s, kernels, True, True),
                         device)
        lib = bench_ms(lambda: focal_chain_cudnn(ctx, gates, weights, s, s, kernels), device,
                       lead_cycles=1_000_000)
        ops = 2 * focal_taps_in_map(s, s, kernels) * XDEC_BATCH * C
        n_bytes = nbytes(ctx, gates, taps, got)
        bd = bound(n_bytes, ops, "f32")
        log(f"K10 {label}: kernel {ms:.4f} ms (host {host[label]} us per call), plain "
            f"{plain:.4f} ms, cuDNN chain {lib:.4f} ms, bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})")
        return dict(ms=ms, plain_ms=plain, library_ms=lib, **bd), n_bytes, ops

    def forward_sum(stage_recs, side):
        """One FocalNet-L forward's 24 launches: the stages' times by depth."""
        tot = dict(ms=0.0, plain=0.0, lib=0.0, bytes=0, ops=0)
        for depth, (r, n_bytes, ops) in zip(fcfg.depths, stage_recs):
            tot = dict(ms=tot["ms"] + depth * r["ms"], plain=tot["plain"] + depth * r["plain_ms"],
                       lib=tot["lib"] + depth * r["library_ms"],
                       bytes=tot["bytes"] + depth * n_bytes, ops=tot["ops"] + depth * ops)
        bd = bound(tot["bytes"], tot["ops"], "f32")
        log(f"K10 one FocalNet-L forward at {side}^2 ({sum(fcfg.depths)} launches): kernel "
            f"{tot['ms']:.4f} ms, plain {tot['plain']:.4f} ms, cuDNN chain {tot['lib']:.4f} ms, "
            f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, {tot['ops'] / 1e9:.1f} GFLOP)")
        return tot, bd

    stages, host, timed = {}, {}, []
    for i, depth in enumerate(fcfg.depths):
        C, s = fcfg.num_features[i], XDEC_SIDE // 4 // 2 ** i
        # the 512 x 640 bucket's map of this stage, then the 512^2 one (timed)
        focal_hold(i, C, s, s * 5 // 4)
        case = focal_hold(i, C, s, s)
        label = f"stage {i + 1} [{XDEC_BATCH},{C},{s}x{s}]"
        timed.append(focal_time(label, C, s, *case, host))
        stages[label] = timed[-1][0]
    tot, bd = forward_sum(timed, XDEC_SIDE)
    # the VLP eval's maps at 224^2 (stage 4: 7 x 7 under the 9 x 9 level)
    vlp_stages, vlp_timed = {}, []
    for i in range(len(fcfg.depths)):
        C, s = fcfg.num_features[i], VLP_SIDE // 4 // 2 ** i
        case = focal_hold(i, C, s, s)
        label = f"stage {i + 1} [{XDEC_BATCH},{C},{s}x{s}]"
        vlp_timed.append(focal_time(label, C, s, *case, host))
        vlp_stages[label] = vlp_timed[-1][0]
    vtot, vbd = forward_sum(vlp_timed, VLP_SIDE)
    rec["focal_ctx"] = dict(
        max_abs_err=max(errs), ms=tot["ms"], plain_ms=tot["plain"], library_ms=tot["lib"], **bd,
        host_us=host, other_shapes=stages,
        vlp_224=dict(stages=vlp_stages, forward=dict(
            ms=vtot["ms"], plain_ms=vtot["plain"], library_ms=vtot["lib"], **vbd)),
        shape=f"FocalNet-L at {XDEC_SIDE}^2, batch {XDEC_BATCH}, bf16, tanh GELU, L=4 (k 3-9): "
              "ms summed over one forward's 24 launches (2, 2, 18, 2 blocks at C 192-1536); "
              "library_ms: the cuDNN depthwise conv2d chain in bf16; vlp_224: the same at "
              f"{VLP_SIDE}^2 (the VLP eval's maps)")
    return rec


def check_nf4_kernels(device, g):
    """Phase 3, K6 and K7: the planar NF4 kernels against their plain
    versions at the three 7B weight shapes.  K7 bit for bit.  K6 at M = 1,
    14, 64, 256, 511 within 1e-2 + 1e-2 |ref| on the bf16 output (one bf16
    ulp, 2^-8 relative, plus the f32 sums taken in another order); its time
    is the sum over the three shapes at the serving decode M (16 slots x
    spec_k 4), K7's the widest shape's."""
    import torch

    from cullavo_tpu_torch.ops import nf4

    bf = torch.bfloat16
    k6 = dict(err=0.0, ms=0.0, plain=0.0, dense=0.0, n_bytes=0, n_ops=0)
    rec = {}
    for K, N in NF4_SHAPES:
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        q = nf4.quantize_linear_planar(w)
        dense = nf4.nf4_dequant_planar(q)
        ref_w = nf4.dequant_linear_planar(q)
        torch.cuda.synchronize(device)
        n_bad = int((dense.view(torch.int16) != ref_w.view(torch.int16)).sum().item())
        qerr = (ref_w.float() - w).abs().max().item()
        log(f"K7 nf4_dequant_planar K={K} N={N}: mismatching bf16 values={n_bad} "
            f"(bit-equal demanded); NF4 rounding of the random weight {qerr:.3e}")
        if n_bad or dense.shape != (K, N):
            raise RuntimeError(f"K7 disagrees with dequant_linear_planar at K={K} N={N}")
        ms = bench_ms(lambda: nf4.nf4_dequant_planar(q), device, lead_cycles=1_000_000)
        host = round(host_us(lambda: nf4.nf4_dequant_planar(q), device), 1)
        plain = bench_ms(lambda: nf4.dequant_linear_planar(q), device, reps=5)
        # one f32 multiply per weight; no PyTorch call takes planar NF4 words
        bd = bound(nbytes(q["q4p"], q["scale"], dense), K * N, "f32")
        log(f"K7 K={K} N={N}: kernel {ms:.4f} ms card alone (host {host} us per call), "
            f"plain {plain:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
            f"{nbytes(q['q4p'], q['scale'], dense) / 1e6:.1f} MB)")
        if (K, N) == NF4_SHAPES[1]:
            rec["nf4_dequant_planar"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain,
                                             library_ms=None, **bd, host_us=host,
                                             shape=f"q4p [{K // 8},{N}] int32 + scale "
                                                   f"[{K},{N // 64}] f32 -> [{K},{N}] bf16")
        for M in (1, 14, SERVE_DECODE_M, 256, 511):
            x = torch.randn((M, K), generator=g, device=device).to(bf)
            y = nf4.nf4_linear_planar(x, q)
            ref = nf4._nf4_linear_planar_plain(x, q)
            torch.cuda.synchronize(device)
            diff = (y.float() - ref.float()).abs()
            err = diff.max().item()
            excess = (diff - 1e-2 - 1e-2 * ref.float().abs()).max().item()
            log(f"K6 nf4_linear_planar M={M} K={K} N={N}: max_abs_err={err:.3e} "
                f"(max |y| {ref.float().abs().max().item():.3f}; tol 1e-2 + 1e-2 |ref|, "
                f"worst excess {excess:.3e})")
            if not (torch.isfinite(y).all() and excess <= 0):
                raise RuntimeError(f"K6 disagrees with its plain version at M={M} K={K} N={N}")
            k6["err"] = max(k6["err"], err)
            if M != SERVE_DECODE_M:
                continue
            ms = bench_ms(lambda: nf4.nf4_linear_planar(x, q), device, lead_cycles=1_000_000)
            plain = bench_ms(lambda: nf4._nf4_linear_planar_plain(x, q), device, reps=5)
            # a yardstick only: the dense bf16 product reads 3.6x the bytes
            dense_ms = bench_ms(lambda: x @ dense, device, lead_cycles=1_000_000)
            log(f"K6 M={M} K={K} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, dense bf16 "
                f"torch.matmul on the dequantized weight {dense_ms:.4f} ms, 4-bit weight "
                f"bytes {nbytes(q['q4p'], q['scale']) / 1e6:.1f} MB")
            k6["ms"], k6["plain"], k6["dense"] = (k6["ms"] + ms, k6["plain"] + plain,
                                                  k6["dense"] + dense_ms)
            k6["n_bytes"] += nbytes(x, q["q4p"], q["scale"], y)
            k6["n_ops"] += 2 * M * K * N
        del w, q, dense, ref_w
    bd = bound(k6["n_bytes"], k6["n_ops"], "bf16")
    log(f"K6 sum of the three shapes at M={SERVE_DECODE_M}: kernel {k6['ms']:.4f} ms, plain "
        f"{k6['plain']:.4f} ms, dense bf16 matmul {k6['dense']:.4f} ms, bound "
        f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {k6['n_bytes'] / 1e6:.1f} MB)")
    rec["nf4_linear_planar"] = dict(max_abs_err=k6["err"], ms=k6["ms"], plain_ms=k6["plain"],
                                    library_ms=None, **bd,
                                    shape=f"M={SERVE_DECODE_M}, (K,N) in (4096,4096),"
                                          "(4096,11008),(11008,4096), ms summed over the three")
    torch.cuda.empty_cache()
    return rec


def check_q4_kernels(device, g):
    """Phase 3, K11: the byte-packed NF4 kernel against its plain versions at
    the three 7B weight shapes.  The dequant entry bit for bit against
    ``dequant_linear``; the fused entry at M = 1, 14, 64, 129, 511 within
    1e-2 + 1e-2 |ref| of the f32 plain version (the kernel takes the f32
    weight as two bf16 terms, 2^-17 relative, and sums in another order;
    both sides round once to bf16, so they differ by one ulp); row 8's
    form: ``quantize_nf4`` of the same weight, its absmax decoded on the card,
    through K11, against ``dequantize_nf4`` + an f32 product.  Timed at
    M = 14 (the greedy batch's decode, the JSON record) and M = 64, summed
    over the three shapes, beside the bound and a yardstick: the dense bf16
    ``torch.matmul`` on the dequantized weight (no PyTorch call takes
    byte-packed NF4)."""
    import torch

    from cullavo_tpu_torch.ops import nf4

    bf = torch.bfloat16
    timed = {M: dict(ms=0.0, plain=0.0, dense=0.0, n_bytes=0, n_ops=0) for M in (BATCH, 64)}
    row8 = dict(err=0.0, ms=0.0, k11=0.0, plain=0.0, n_bytes=0, n_ops=0)
    err, rec = 0.0, {}
    for K, N in NF4_SHAPES:
        w = torch.randn((K, N), generator=g, device=device) * K ** -0.5
        q = nf4.quantize_linear(w)
        dense = nf4.nf4_dequant_q4(q, K)
        ref_w = nf4.dequant_linear(q, K, N)
        torch.cuda.synchronize(device)
        n_bad = int((dense.view(torch.int16) != ref_w.view(torch.int16)).sum().item())
        log(f"K11 nf4_dequant_q4 K={K} N={N}: mismatching bf16 values={n_bad} (bit-equal "
            "demanded)")
        if n_bad or dense.shape != (K, N):
            raise RuntimeError(f"K11 dequant disagrees with dequant_linear at K={K} N={N}")
        if (K, N) == NF4_SHAPES[1]:
            ms = bench_ms(lambda: nf4.nf4_dequant_q4(q, K), device)
            plain = bench_ms(lambda: nf4.dequant_linear(q, K, N), device, reps=5)
            bd = bound(nbytes(q["q4"], q["scale"], dense), K * N, "f32")
            log(f"K11 dequant K={K} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, bound "
                f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
            rec["nf4_dequant_q4"] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain, library_ms=None,
                                         **bd, shape=f"q4 [{K},{N // 2}] uint8 + scale "
                                                     f"[{K},{N // 64}] f32 -> [{K},{N}] bf16")
        for M in (1, BATCH, 64, 129, 511):
            x = torch.randn((M, K), generator=g, device=device).to(bf)
            y = nf4.nf4_linear_q4(x, q, K)
            ref = nf4._nf4_linear_q4_plain(x, q, K, N)
            torch.cuda.synchronize(device)
            diff = (y.float() - ref.float()).abs()
            excess = (diff - 1e-2 - 1e-2 * ref.float().abs()).max().item()
            log(f"K11 nf4_linear_q4 M={M} K={K} N={N}: max_abs_err={diff.max().item():.3e} (max "
                f"|y| {ref.float().abs().max().item():.3f}; tol 1e-2 + 1e-2 |ref|, worst excess "
                f"{excess:.3e})")
            if not (torch.isfinite(y).all() and excess <= 0):
                raise RuntimeError(f"K11 disagrees with its plain version at M={M} K={K} N={N}")
            err = max(err, diff.max().item())
            if M not in timed:
                continue
            ms = bench_ms(lambda: nf4.nf4_linear_q4(x, q, K), device, lead_cycles=1_000_000)
            plain = bench_ms(lambda: nf4._nf4_linear_q4_plain(x, q, K, N), device, reps=5)
            dense_ms = bench_ms(lambda: x @ dense, device, lead_cycles=1_000_000)
            log(f"K11 M={M} K={K} N={N}: kernel {ms:.4f} ms, plain {plain:.4f} ms, dense bf16 "
                f"torch.matmul on the dequantized weight {dense_ms:.4f} ms")
            t = timed[M]
            t["ms"], t["plain"], t["dense"] = t["ms"] + ms, t["plain"] + plain, t["dense"] + dense_ms
            t["n_bytes"] += nbytes(x, q["q4"], q["scale"], y)
            t["n_ops"] += 2 * M * K * N
        # row 8: an NF4Tensor (double-quantized absmax) through the same kernel
        t8 = nf4.quantize_nf4(w)
        x = torch.randn((BATCH, K), generator=g, device=device).to(bf)
        y8 = nf4.nf4_matmul_fused(x, t8)
        ref8 = (x.float() @ nf4.dequantize_nf4(t8, torch.float32)).to(bf)
        torch.cuda.synchronize(device)
        d8 = (y8.float() - ref8.float()).abs()
        excess = (d8 - 1e-2 - 1e-2 * ref8.float().abs()).max().item()
        log(f"K11 as row 8 (nf4_matmul_fused, NF4Tensor, absmax decoded on the card) M={BATCH} "
            f"K={K} N={N}: max_abs_err={d8.max().item():.3e} (worst excess {excess:.3e})")
        if not (torch.isfinite(y8).all() and excess <= 0):
            raise RuntimeError(f"row 8 through K11 disagrees with dequantize_nf4 at K={K} N={N}")
        row8["err"] = max(row8["err"], d8.max().item())
        row8["ms"] += bench_ms(lambda: nf4.nf4_matmul_fused(x, t8), device,
                               lead_cycles=1_000_000)
        absmax8 = nf4._decode_absmax(t8)
        row8["k11"] += bench_ms(lambda: nf4._nf4_q4_cuda("nf4_matmul_fused", x, t8.packed,
                                                          absmax8, K, N), device,
                                lead_cycles=1_000_000)
        row8["plain"] += bench_ms(
            lambda: (x.float() @ nf4.dequantize_nf4(t8, torch.float32)).to(bf), device, reps=5)
        row8["n_bytes"] += nbytes(x, t8.packed, t8.absmax, t8.absmax_scale, t8.absmax_offset, y8)
        row8["n_ops"] += 2 * BATCH * K * N
        del w, q, dense, ref_w, t8
    for M, t in timed.items():
        bd = bound(t["n_bytes"], t["n_ops"], "bf16")
        log(f"K11 sum of the three shapes at M={M}: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain']:.4f} ms, dense bf16 matmul {t['dense']:.4f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}, {t['n_bytes'] / 1e6:.1f} MB)")
    bd = bound(row8["n_bytes"], row8["n_ops"], "bf16")
    log(f"K11 as row 8, sum of the three shapes at M={BATCH} (absmax decode included): "
        f"{row8['ms']:.4f} ms (K11 alone {row8['k11']:.4f} ms), plain (dequantize_nf4 + f32 "
        f"product) {row8['plain']:.4f} ms, "
        f"bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, {row8['n_bytes'] / 1e6:.1f} MB), "
        f"max_abs_err {row8['err']:.3e}")
    t = timed[BATCH]
    rec["nf4_linear_q4"] = dict(max_abs_err=max(err, row8["err"]), ms=t["ms"], plain_ms=t["plain"],
                                library_ms=None, **bound(t["n_bytes"], t["n_ops"], "bf16"),
                                shape=f"M={BATCH}, (K,N) in (4096,4096),(4096,11008),"
                                      "(11008,4096), ms summed over the three")
    torch.cuda.empty_cache()
    return rec


def check_wwin_kernels(device, g):
    """Phase 3, K4 and K5: the cache part of the W-window decode attention
    against its plain version, over a stacked 32-layer cache at the paths'
    shapes: decode windows of W = 1 and 4 over the batch of 14 (S = 768 for
    the speculative batch, a 664-slot view for the plain greedy batch;
    per-row valid lengths, one row with no valid slot), and the serving
    engine's suffix prefills, W = 32, 64 and 128 over a prefill chunk of 4
    rows whose cache is gated to the shared 608-token prefix, as
    ``generate_prefill_prefix`` gates it.  acc within 2e-3 relative +
    2^-8 * l (the kernel rounds each probability to bf16 against its warp's
    running maximum, the plain version against the final one), m and l
    within 2e-3 relative, the merged bf16 output within 1e-2 + 1e-2 |ref|
    (one bf16 ulp).  Each shape timed in turns with the library's
    ``scaled_dot_product_attention`` over the layer's slice (a yardstick the
    port never calls; for K5 over the slice dequantized to bf16 beforehand,
    twice K5's bytes) and, for K5, K4 over the bf16 cache the int8 one was
    quantized from (twice the bytes too), the card kept busy ahead of each
    timed call (host microseconds per call apart).  Then K4 and K5 at their
    edges (``check_wwin_edges``)."""
    import torch

    from cullavo_tpu_torch.models.llava.llama import quantize_kv, round_cache_len
    from cullavo_tpu_torch.ops import wwin_decode as ww

    bf = torch.bfloat16
    L, B, KV, hd = 32, BATCH, 32, 128
    T = PAD_TO * -(-(1 + 576 + PROMPT_TEXT) // PAD_TO)
    S_spec, S_plain = round_cache_len(T + NEW_TOKENS + SPEC_K), T + NEW_TOKENS
    scale = hd ** -0.5
    cache = {"k": torch.empty((L, S_spec, B, KV, hd), dtype=bf, device=device),
             "v": torch.empty((L, S_spec, B, KV, hd), dtype=bf, device=device)}
    q8 = {name: torch.empty((L, S_spec, B, KV, hd), dtype=torch.int8, device=device)
          for name in ("k", "v")}
    q8.update({name: torch.empty((L, S_spec, B, KV), dtype=bf, device=device)
               for name in ("k_s", "v_s")})
    for li in range(L):   # layer by layer: the f32 draws of a whole cache would be 11 GB
        for name in ("k", "v"):
            cache[name][li] = torch.randn((S_spec, B, KV, hd), generator=g, device=device)
            q8[name][li], q8[name + "_s"][li] = quantize_kv(cache[name][li])
    masked_row = 3
    n_valid = torch.randint(T - 7, T + NEW_TOKENS, (B,), generator=g, device=device)
    n_valid[masked_row] = 0                                  # a row with no valid slot
    # a suffix prefill: every row of the chunk reads the same stored prefix
    B_sfx = SERVE_CFG["PREFILL_CHUNK"]
    prefix_len = (1 + SERVE_HEAD_TEXT + 576 + SERVE_SHARED_TEXT) // 32 * 32
    n_valid_sfx = torch.full((B_sfx,), prefix_len, device=device)

    def window(W, S, n_val):
        Bw = n_val.shape[0]
        q = torch.randn((Bw, W, KV, hd), generator=g, device=device).to(bf).transpose(1, 2)
        k_cur, v_cur = (torch.randn((Bw, KV, W, hd), generator=g, device=device).to(bf)
                        for _ in range(2))
        ok = torch.arange(S, device=device)[None, :] < n_val[:, None]
        bias = torch.where(ok, 0.0, ww.NEG_INF)[:, None, None, :].expand(Bw, 1, W, S).contiguous()
        return q, k_cur, v_cur, bias

    def partial_err(got, want, masked):
        (acc, m, l), (acc_r, m_r, l_r) = got, want
        for name, a, r in (("m", m, m_r), ("l", l, l_r)):
            if not torch.allclose(a, r, rtol=2e-3, atol=1e-3):
                raise RuntimeError(f"{name} disagrees: {(a - r).abs().max().item()}")
        excess = (acc - acc_r).abs() - 2e-3 * acc_r.abs() - 2.0 ** -8 * l_r[..., None]
        if not (excess <= 0).all() or (masked is not None
                                       and (acc[masked].any() or l[masked].any())):
            raise RuntimeError(f"acc disagrees: excess {excess.max().item()}")
        return (acc - acc_r).abs().max().item()

    cases = [(W, S, False) for S in (S_spec, S_plain) for W in (1, SPEC_K)]
    cases += [(W, S_spec, True) for W in SERVE_SUFFIX_W]

    rec = {}
    bf16_sfx = tuple(t[:, :, :B_sfx].contiguous() for t in (cache["k"], cache["v"]))
    for name, kernel, plain, wrapper, tensors in (
            ("wwin_decode", ww._run_cache_part, ww._cache_part_plain, ww.wwin_decode_smajor,
             (cache["k"], cache["v"])),
            ("wwin_decode_q8", ww._run_cache_part_q8, ww._cache_part_q8_plain,
             ww.wwin_decode_smajor_q8, (q8["k"], q8["k_s"], q8["v"], q8["v_s"]))):
        worst = 0.0
        # the suffix prefill's cache: a dense copy of the prefix for each chunk row
        sfx_tensors = tuple(t[:, :, :B_sfx].contiguous() for t in tensors)
        for W, S, suffix in cases:
            n_val, masked = (n_valid_sfx, None) if suffix else (n_valid, masked_row)
            Bw = n_val.shape[0]
            # S = 664: a strided view
            ops = sfx_tensors if suffix else tuple(t[:, :S] for t in tensors)
            q, k_cur, v_cur, bias = window(W, S, n_val)
            win = None
            if name == "wwin_decode_q8" and W > 1:
                win = (*quantize_kv(k_cur.permute(2, 0, 1, 3)),
                       *quantize_kv(v_cur.permute(2, 0, 1, 3)))
            for li in (0, L // 2, L - 1) if S == S_spec else (L - 1,):
                got = kernel(q, *ops, li, bias[:, 0], 1, scale)
                want = plain(q, *ops, li, bias[:, 0], 1, scale)
                torch.cuda.synchronize(device)
                acc_err = partial_err(got, want, masked)
                kw = {} if win is None else {"win_q8": win}
                out = wrapper(q, *ops, li, k_cur, v_cur, bias, **kw)
                ref = ww._merge_self_window(q, k_cur, v_cur, *want, scale, **kw)
                torch.cuda.synchronize(device)
                err = (out.float() - ref.float()).abs().max().item()
                worst = max(worst, err)
                log(f"{name} B={Bw} W={W} S={S} li={li}: acc max_abs_err={acc_err:.3e} (tol 2e-3 "
                    f"rel + 2^-8 l), merged bf16 output max_abs_err={err:.3e} (tol 1e-2 + 1e-2 "
                    "|ref|)")
                if not (torch.isfinite(out).all()
                        and torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2)):
                    raise RuntimeError(f"{name} disagrees with its plain version: {err}")
            # what this run's data needs: the valid slots' k and v (and scale
            # planes), q, bias and the partials; 4 operations per q.k and p.v term
            n_slots = int(n_val.clamp_max(S).sum().item())
            esz = tensors[0].element_size()
            need = (2 * n_slots * KV * hd * esz + (4 * n_slots * KV if len(tensors) == 4 else 0)
                    + nbytes(q, bias[:, 0], *got))
            bd = bound(need, 4 * n_slots * KV * W * hd, "bf16")
            li = L // 2
            fns = {"kernel": lambda: kernel(q, *ops, li, bias[:, 0], 1, scale)}
            # a yardstick timed here only (the port never calls it): the
            # normalised cache-only attention over the layer's slice (K5:
            # dequantized to bf16 outside the timed call)
            if name == "wwin_decode":
                kl, vl = (t[li].permute(1, 2, 0, 3) for t in ops)
            else:
                kl, vl = ((c[li].float() * s_[li].float()[..., None]).to(bf).permute(1, 2, 0, 3)
                          for c, s_ in ((ops[0], ops[1]), (ops[2], ops[3])))
                bf_ops = bf16_sfx if suffix else (cache["k"][:, :S], cache["v"][:, :S])
                fns["k4_bf16"] = lambda: ww._run_cache_part(q, *bf_ops, li, bias[:, 0], 1, scale)
            fns["library"] = lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kl, vl, attn_mask=bias)
            med, turns, host = timed_turns(fns, device)
            ms, lib = med["kernel"], med["library"]
            plain_ms = bench_ms(lambda: plain(q, *ops, li, bias[:, 0], 1, scale), device, reps=5)
            k4 = f", K4 on the bf16 cache {med['k4_bf16']:.4f} ms" if "k4_bf16" in med else ""
            log(f"{name} B={Bw} W={W} S={S}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"sdpa{' (dequantized slice, a yardstick)' if 'k4_bf16' in med else ''} "
                f"{lib:.4f} ms{k4}, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}, "
                f"{need / 1e6:.1f} MB needed); in turns {turns}; host us per call {host}")
            shape = (f"q [{Bw},{KV},{W},{hd}] bf16, cache [{L},{S},{B},{KV},{hd}] "
                     f"{str(tensors[0].dtype).split('.')[1]}"
                     + (f", a dense copy of rows 0-{Bw - 1}" if suffix else "") + ", one layer")
            times = dict(ms=ms, plain_ms=plain_ms, library_ms=lib, **bd, times_in_turns=turns,
                         host_us=host, shape=shape)
            if name == "wwin_decode_q8":
                # no PyTorch call takes int8 codes with scale planes: the
                # kernel line's library column stays empty, the yardsticks beside it
                times.update(library_ms=None, sdpa_dequantized_ms=lib, k4_bf16_ms=med["k4_bf16"])
            # the record keeps each kernel at the shape its main path gives it:
            # K4 the plain greedy step (W = 1, S = 664), K5 the speculative
            # window; the other shapes beside it
            if (W, S, suffix) == ((1, S_plain, False) if name == "wwin_decode"
                                  else (SPEC_K, S_spec, False)):
                rec.setdefault(name, {}).update(times)
            else:
                rec.setdefault(name, {}).setdefault("other_shapes", {})[
                    f"W={W} S={S} B={Bw}"] = times
        rec[name]["max_abs_err"] = worst
        del sfx_tensors, ops
    for name in ("wwin_decode", "wwin_decode_q8"):
        rec[name]["max_abs_err"] = max(rec[name]["max_abs_err"],
                                       check_wwin_edges(device, g, cache, n_valid, partial_err,
                                                        window, q8=name == "wwin_decode_q8"))
    del cache, q8, bf16_sfx
    torch.cuda.empty_cache()
    return rec


def check_wwin_edges(device, g, cache, n_valid, partial_err, window, q8=False):
    """Phase 3, K4 (or, with ``q8``, K5 over the same caches quantized) at
    its edges, each body against the plain version at phase 3's K4
    tolerances: batch 1 at S = 4000 (one block per kv head walking every
    slot; W = 1 on the lane-group body, W = 8 on the mma body) with slots
    500-999 wholly masked and the slots past 3900 masked too; S = 40,
    shorter than the mma body's 64-slot stage; and GQA, 32 query heads on
    the first 8 kv heads of the cache (n_rep = 4, a strided view).  Returns
    the largest merged-output error."""
    import torch

    from cullavo_tpu_torch.models.llava.llama import quantize_kv
    from cullavo_tpu_torch.ops import wwin_decode as ww

    bf, hd, scale = torch.bfloat16, 128, 128 ** -0.5
    S_long, KV = 4000, 32
    long_cache = [torch.randn((2, S_long, 1, KV, hd), generator=g, device=device).to(bf)
                  for _ in range(2)]
    worst = 0.0
    name = "wwin_decode_q8" if q8 else "wwin_decode"
    run, plain, wrapper = ((ww._run_cache_part_q8, ww._cache_part_q8_plain,
                            ww.wwin_decode_smajor_q8) if q8 else
                           (ww._run_cache_part, ww._cache_part_plain, ww.wwin_decode_smajor))

    def hold(label, q, kc, vc, li, k_cur, v_cur, bias, n_rep=1, masked=None):
        # K5: codes and planes quantized from the view (dense copies)
        ops = (*quantize_kv(kc), *quantize_kv(vc)) if q8 else (kc, vc)
        got = run(q, *ops, li, bias[:, 0], n_rep, scale)
        want = plain(q, *ops, li, bias[:, 0], n_rep, scale)
        again = run(q, *ops, li, bias[:, 0], n_rep, scale)
        torch.cuda.synchronize(device)
        acc_err = partial_err(got, want, masked)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"{name} {label}: a second launch is not bit-equal")
        out = wrapper(q, *ops, li, k_cur, v_cur, bias, n_rep=n_rep)
        ref = ww._merge_self_window(q, torch.repeat_interleave(k_cur, n_rep, dim=1),
                                    torch.repeat_interleave(v_cur, n_rep, dim=1), *want, scale)
        torch.cuda.synchronize(device)
        err = (out.float() - ref.float()).abs().max().item()
        log(f"{name} {label}: acc max_abs_err={acc_err:.3e} (tol 2e-3 rel + 2^-8 l), "
            f"merged bf16 output max_abs_err={err:.3e} (tol 1e-2 + 1e-2 |ref|)")
        if not (torch.isfinite(out).all()
                and torch.allclose(out.float(), ref.float(), rtol=1e-2, atol=1e-2)):
            raise RuntimeError(f"{name} {label} disagrees with its plain version: {err}")
        return err

    for W in (1, 8):
        q, k_cur, v_cur, bias = window(W, S_long, torch.tensor([3900], device=device))
        bias[:, :, :, 500:1000] = ww.NEG_INF                 # a masked run of slots
        worst = max(worst, hold(f"B=1 W={W} S={S_long}, slots 500-999 masked", q, *long_cache,
                                1, k_cur, v_cur, bias))
    q, k_cur, v_cur, bias = window(8, 40, torch.tensor([37], device=device))
    short = [t[:, :40] for t in long_cache]
    worst = max(worst, hold("B=1 W=8 S=40 (below one 64-slot stage)", q, *short, 0, k_cur, v_cur,
                            bias))
    T = n_valid.shape[0]
    # GQA: 32 query heads over the cache's first 8 kv heads (a strided view)
    q, k_cur, v_cur, bias = window(1, 664, n_valid)
    q = torch.randn((T, 1, 32, hd), generator=g, device=device).to(bf).transpose(1, 2)
    k_cur, v_cur = (t[:, :8] for t in (k_cur, v_cur))
    worst = max(worst, hold(f"B={T} W=1 S=664 GQA (32 heads on 8 kv heads)", q,
                            cache["k"][:, :664, :, :8], cache["v"][:, :664, :, :8], 5, k_cur,
                            v_cur, bias, n_rep=4, masked=3))
    del long_cache
    return worst


def check_decode_kernels(device, g):
    """Phase 3, K12 (one-token decode attention) against its plain version
    on the same inputs.  Row 5's form through ``flash_decode``'s mask
    (``kv_valid[b, s] & s <= q_position[b]`` as an additive bias): the
    LLaMA-7B decode shape [14, 32, 768, 128] bf16 with KV = H, a GQA case
    with KV = 8, S = 700 (not a multiple of 128) and a wholly masked row
    at S = 768 (the mean of v).  The edges of the lane-group body: batch 1
    at S = 4000 (one block per kv head walking every key) with keys 500-999
    wholly masked by the finite mask and, through ``decode_partials``, at
    -inf for half the heads; GQA (KV = 8); f32 at d = 64; S = 100.  The
    zoo's forms through ``sdpa_decode_stale`` (the current
    token merged in f32) against ``sdpa_decode_stale_plain`` (JAX's
    arithmetic), each over a layer of the stacked f32 cache read in place:
    T5-XL's decoder (5 beams, 32 heads, S = 11, d = 64, scale 1, a per-head
    relative bias + the causal mask, ``self_bias``) and KOSMOS-2's (1 row,
    32 heads, S = its longest prompt + 10, d = 64, scaled, a key-validity
    mask) at the first, a middle and the last decode step.  Tolerances:
    1e-5 + 1e-5 |ref| in f32 and 1e-2 + 1e-2 |ref| in bf16 (the plain
    version widens the same inputs to f32 and sums in another order; in
    bf16 the output rounds once, at up to one ulp); m and l within 1e-5.
    Timed at the 7B shape with every key valid and at the zoo's shapes,
    each in turns with ``scaled_dot_product_attention`` (a boolean mask at 7B, the f32
    additive bias at the zoo's shapes; a yardstick the port never calls),
    the card kept busy ahead of each timed call so that the events time the
    card alone (host microseconds per call apart); the plain version once;
    the bound from the valid cache bytes over 3.35 TB/s."""
    import torch

    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.llava.llama import sdpa_decode_stale, sdpa_decode_stale_plain
    from cullavo_tpu_torch.ops import flash_attention as fa
    from cullavo_tpu_torch.pipelines.vl_zoo_pipeline import MODEL_SPECS

    bf, f32 = torch.bfloat16, torch.float32
    tols = {f32: 1e-5, bf: 1e-2}
    sdpa_lib = torch.nn.functional.scaled_dot_product_attention   # a yardstick only
    lead = 1_000_000

    def hold(label, got, want, dtype):
        err = (got.float() - want.float()).abs().max().item()
        log(f"K12 {label}: max_abs_err={err:.3e} (tol {tols[dtype]:g} + {tols[dtype]:g} |ref|)")
        if not (torch.isfinite(got).all()
                and torch.allclose(got.float(), want.float(), atol=tols[dtype],
                                   rtol=tols[dtype])):
            raise RuntimeError(f"K12 disagrees with its plain version at {label}: {err}")
        return err

    def partials(label, q, k, v, bias, scale):
        """K12 against the plain version: o within the tolerance, m and l
        within 1e-5 relative (one f32 rounding of the dot each)."""
        B, H, S = q.shape[0], q.shape[1], k.shape[2]
        got = fa.decode_partials(q, k, v, bias, scale)
        want = fa._decode_partials_plain(q, k, v, bias.float().expand(B, H, S), scale)
        torch.cuda.synchronize(device)
        for name, a, r in zip("ml", got[1:], want[1:]):
            if not torch.allclose(a, r, atol=1e-5, rtol=1e-5):
                raise RuntimeError(f"K12 {name} disagrees at {label}: {(a - r).abs().max()}")
        again = fa.decode_partials(q, k, v, bias, scale)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise RuntimeError(f"K12 at {label}: a second launch is not bit-equal")
        return hold(label, got[0], want[0], q.dtype), got, want

    worst = 0.0
    B, H, S, d = BATCH, 32, 768, 128
    for KV, S_case, masked in ((32, S, False), (8, S, False), (32, 700, False), (32, S, True)):
        q = torch.randn((B, H, 1, d), generator=g, device=device).to(bf)
        k, v = (torch.randn((B, KV, S_case, d), generator=g, device=device).to(bf)
                for _ in range(2))
        pos = torch.randint(S_case // 2, S_case, (B,), generator=g, device=device)
        valid = (torch.rand((B, S_case), generator=g, device=device) > 0.05).to(torch.int32)
        if masked:
            pos[5] = -1                                  # row 5 sees no key
        label = f"flash_decode [{B},{H}/{KV},{S_case},{d}] bf16" + (" masked row" if masked else "")
        err, _, want = partials(label, q, k, v, fa.decode_bias(pos, valid), d ** -0.5)
        out = fa.flash_decode(q, k, v, pos, valid)
        worst = max(worst, err, hold(label + " (entry)", out[:, :, 0], want[0], bf))
        if masked and not torch.allclose(out[5, :, 0].float(), v[5].float().mean(dim=1),
                                         atol=1e-2, rtol=1e-2):
            raise RuntimeError("K12: the wholly masked row is not the mean of v")

    # batch 1 at S = 4000: one block per kv head walks every key
    S_long = 4000
    for KV, dt, dd in ((32, bf, 128), (8, bf, 128), (32, f32, 64)):
        q = torch.randn((1, H, 1, dd), generator=g, device=device).to(dt)
        k, v = (torch.randn((1, KV, S_long, dd), generator=g, device=device).to(dt)
                for _ in range(2))
        valid = torch.ones((1, S_long), dtype=torch.int32, device=device)
        valid[:, 500:1000] = 0                            # a run of masked keys
        pos = torch.full((1,), S_long - 1, device=device)
        label = f"flash_decode [1,{H}/{KV},{S_long},{dd}] {str(dt).split('.')[1]}"
        bias = fa.decode_bias(pos, valid)
        worst = max(worst, partials(label + ", keys 500-999 masked", q, k, v, bias,
                                    dd ** -0.5)[0])
        bias_inf = bias.expand(1, H, S_long).clone()
        bias_inf[:, : H // 2, 500:1000] = -torch.inf      # -inf keys count 0
        worst = max(worst, partials(label + ", keys 500-999 at -inf for 16 heads", q, k, v,
                                    bias_inf, dd ** -0.5)[0])
    q = torch.randn((1, H, 1, d), generator=g, device=device).to(bf)
    k, v = (torch.randn((1, H, 100, d), generator=g, device=device).to(bf) for _ in range(2))
    worst = max(worst, partials("flash_decode [1,32,100,128] bf16", q, k, v,
                                torch.zeros((1, 1, 100), device=device), d ** -0.5)[0])

    # timing at the 7B decode shape, every key valid (the bound's bytes)
    q = torch.randn((B, H, 1, d), generator=g, device=device).to(bf)
    k, v = (torch.randn((B, H, S, d), generator=g, device=device).to(bf) for _ in range(2))
    valid = torch.ones((B, S), dtype=torch.int32, device=device)
    pos = torch.full((B,), S - 1, device=device)
    bias = fa.decode_bias(pos, valid)
    err, got, _ = partials(f"timing case [{B},{H},{S},{d}] bf16", q, k, v, bias, d ** -0.5)
    worst = max(worst, err)
    mask = (bias == 0)[:, :, None, :]                      # [B, 1, 1, S] boolean
    med, turns, host = timed_turns(
        {"kernel": lambda: fa.decode_partials(q, k, v, bias, d ** -0.5),
         "library": lambda: sdpa_lib(q, k, v, attn_mask=mask)}, device)
    plain = bench_ms(lambda: fa._decode_partials_plain(q, k, v, bias.expand(B, H, S), d ** -0.5),
                     device, reps=5)
    bd = bound(nbytes(q, k, v, bias, *got), 4 * B * H * S * d, "bf16")
    log(f"K12 [{B},{H},{S},{d}] bf16: kernel {med['kernel']:.4f} ms, plain {plain:.4f} ms, "
        f"library sdpa (boolean mask) {med['library']:.4f} ms, bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']}, {nbytes(k, v) / 1e6:.1f} MB of cache); in turns {turns}; host us "
        f"per call {host}")
    rec = dict(ms=med["kernel"], plain_ms=plain, library_ms=med["library"], **bd,
               times_in_turns=turns, host_us=host,
               shape=f"q [{B},{H},1,{d}], k/v [{B},{H},{S},{d}] bf16, every key valid")
    del q, k, v, bias, got, mask

    # the zoo's forms, over one layer of a stacked f32 cache
    tok = ByteTokenizer()
    prompt = 1 + 64 + max(len(tok.encode(MODEL_SPECS["kosmos2"].prompt.format(q=x)))
                          for x in VL_QUESTION_TEXT)
    rec["zoo_shapes"] = {}
    for name, Bz, Sz, n0, scale, t5 in (("T5-XL decoder", ZOO_BEAMS, ZOO_NEW + 1, 0, 1.0, True),
                                        ("KOSMOS-2 decoder", 1, prompt + ZOO_NEW, prompt,
                                         64 ** -0.5, False)):
        kc, vc = (torch.randn((24, Bz, 32, Sz, 64), generator=g, device=device) for _ in range(2))
        li = 11
        for step in (0, ZOO_NEW // 2, ZOO_NEW - 1):
            q, k_cur, v_cur = (torch.randn((Bz, 32, 1, 64), generator=g, device=device)
                               for _ in range(3))
            written = torch.arange(Sz, device=device) < n0 + step
            if t5:
                bias = (torch.randn((1, 32, 1, Sz), generator=g, device=device)
                        + torch.where(written, 0.0, -1e9))
                self_bias = torch.randn((1, 32, 1, 1), generator=g, device=device)
            else:
                bias = torch.where(written, 0.0, -1e9).expand(Bz, 1, 1, Sz)
                self_bias = None
            label = f"{name} B={Bz} S={Sz} step {step}"
            worst = max(worst, partials(label, q, kc[li], vc[li], bias[:, :, 0], scale)[0])
            out = sdpa_decode_stale(q, kc[li], vc[li], k_cur, v_cur, bias, self_bias=self_bias,
                                    scale=scale)
            ref = sdpa_decode_stale_plain(q, kc[li], vc[li], k_cur, v_cur, bias,
                                          self_bias=self_bias, scale=scale)
            worst = max(worst, hold(label + " merged", out, ref, f32))
        kl, vl, bl = kc[li], vc[li], bias[:, :, 0]
        # the library's sdpa with the same f32 additive bias [B|1, 32|1, 1, S]
        med, turns, host = timed_turns({
            "kernel": lambda: fa.decode_partials(q, kl, vl, bl, scale),
            "library": lambda: sdpa_lib(q, kl, vl, attn_mask=bias, scale=scale)}, device)
        z_plain = bench_ms(lambda: fa._decode_partials_plain(
            q, kl, vl, bl.expand(Bz, 32, Sz), scale), device)
        z_merged = bench_ms(lambda: sdpa_decode_stale(q, kl, vl, k_cur, v_cur, bias,
                                                      self_bias=self_bias, scale=scale), device,
                            lead_cycles=lead)
        z_bd = bound(nbytes(q, kl, vl, bias), 4 * Bz * 32 * Sz * 64, "f32")
        log(f"K12 {name} [{Bz},32,{Sz},64] f32: kernel {med['kernel']:.4f} ms, plain "
            f"{z_plain:.4f} ms, library sdpa (f32 bias) {med['library']:.4f} ms, "
            f"sdpa_decode_stale (K12 + the f32 merge) {z_merged:.4f} ms, bound "
            f"{z_bd['bound_ms']:.6f} ms ({z_bd['bound_by']}); in turns {turns}; host us per "
            f"call {host}")
        rec["zoo_shapes"][name] = dict(ms=med["kernel"], plain_ms=z_plain,
                                       library_ms=med["library"], merged_ms=z_merged,
                                       bound_ms=z_bd["bound_ms"], times_in_turns=turns,
                                       host_us=host, shape=f"q [{Bz},32,1,64], k/v one layer of "
                                                           f"[24,{Bz},32,{Sz},64] f32")
        del kc, vc, kl, vl

    # InstructBLIP's Vicuna decoder (phase 19a): f32, 5 beams x 32 heads,
    # d = 128, one layer of the S-major cache [L, S, B, KV, d] read through
    # its [B, KV, S, d] view in place (the stale decode's [B, 1, S] bias)
    Bi, Si = ZOO_BEAMS, ib_cache_len()
    n_prompt = Si - ZOO_NEW - 1
    kc, vc = (torch.randn((4, Si, Bi, 32, 128), generator=g, device=device) for _ in range(2))
    kl, vl = kc[2].permute(1, 2, 0, 3), vc[2].permute(1, 2, 0, 3)
    for step in (1, ZOO_NEW // 2, ZOO_NEW - 1):
        q, k_cur, v_cur = (torch.randn((Bi, 32, 1, 128), generator=g, device=device)
                           for _ in range(3))
        bias = torch.where(torch.arange(Si, device=device) < n_prompt + step - 1, 0.0,
                           -1e9).expand(Bi, 1, 1, Si)
        label = f"InstructBLIP Vicuna decoder B={Bi} S={Si} step {step} (S-major view)"
        worst = max(worst, partials(label, q, kl, vl, bias[:, :, 0], 128 ** -0.5)[0])
        out = sdpa_decode_stale(q, kl, vl, k_cur, v_cur, bias)
        ref = sdpa_decode_stale_plain(q, kl.contiguous(), vl.contiguous(), k_cur, v_cur, bias)
        worst = max(worst, hold(label + " merged", out, ref, f32))
    bl = bias[:, :, 0]
    mask = (bias == 0)                                     # [B, 1, 1, S] boolean
    med, turns, host = timed_turns({
        "kernel": lambda: fa.decode_partials(q, kl, vl, bl, 128 ** -0.5),
        "library": lambda: sdpa_lib(q, kl, vl, attn_mask=mask)}, device)
    i_plain = bench_ms(lambda: fa._decode_partials_plain(
        q, kl, vl, bl.expand(Bi, 32, Si), 128 ** -0.5), device)
    i_merged = bench_ms(lambda: sdpa_decode_stale(q, kl, vl, k_cur, v_cur, bias), device,
                        lead_cycles=lead)
    i_bd = bound(nbytes(q, kl, vl, bl), 4 * Bi * 32 * Si * 128, "f32")
    log(f"K12 InstructBLIP Vicuna decoder [{Bi},32,{Si},128] f32 (S-major view, strides "
        f"{tuple(kl.stride())}): kernel {med['kernel']:.4f} ms, plain {i_plain:.4f} ms, library "
        f"sdpa (boolean mask) {med['library']:.4f} ms, sdpa_decode_stale (K12 + the f32 merge) "
        f"{i_merged:.4f} ms, bound {i_bd['bound_ms']:.6f} ms ({i_bd['bound_by']}); in turns "
        f"{turns}; host us per call {host}")
    rec["zoo_shapes"]["InstructBLIP Vicuna decoder"] = dict(
        ms=med["kernel"], plain_ms=i_plain, library_ms=med["library"], merged_ms=i_merged,
        bound_ms=i_bd["bound_ms"], times_in_turns=turns, host_us=host,
        shape=f"q [{Bi},32,1,128], k/v one layer of [4,{Si},{Bi},32,128] f32 through "
              "permute(1, 2, 0, 3)")
    del kc, vc, kl, vl

    # BLIP-2 OPT-2.7b's decoder (phase 21a): f32, 5 beams x 32 heads, d = 80,
    # one layer of the head-major cache [L, B, H, S, 80] read in place
    Bo, So = ZOO_BEAMS, opt_cache_len()
    n_prompt = So - ZOO_NEW - 1
    kc, vc = (torch.randn((4, Bo, 32, So, 80), generator=g, device=device) for _ in range(2))
    kl, vl = kc[2], vc[2]
    for step in (1, ZOO_NEW // 2, ZOO_NEW - 1):
        q, k_cur, v_cur = (torch.randn((Bo, 32, 1, 80), generator=g, device=device)
                           for _ in range(3))
        bias = torch.where(torch.arange(So, device=device) < n_prompt + step - 1, 0.0,
                           -1e9).expand(Bo, 1, 1, So)
        label = f"BLIP-2 OPT-2.7b decoder B={Bo} S={So} d=80 step {step}"
        worst = max(worst, partials(label, q, kl, vl, bias[:, :, 0], 80 ** -0.5)[0])
        out = sdpa_decode_stale(q, kl, vl, k_cur, v_cur, bias)
        ref = sdpa_decode_stale_plain(q, kl, vl, k_cur, v_cur, bias)
        worst = max(worst, hold(label + " merged", out, ref, f32))
    bl = bias[:, :, 0]
    mask = (bias == 0)                                     # [B, 1, 1, S] boolean
    med, turns, host = timed_turns({
        "kernel": lambda: fa.decode_partials(q, kl, vl, bl, 80 ** -0.5),
        "library": lambda: sdpa_lib(q, kl, vl, attn_mask=mask)}, device)
    o_plain = bench_ms(lambda: fa._decode_partials_plain(
        q, kl, vl, bl.expand(Bo, 32, So), 80 ** -0.5), device)
    o_merged = bench_ms(lambda: sdpa_decode_stale(q, kl, vl, k_cur, v_cur, bias), device,
                        lead_cycles=lead)
    o_bd = bound(nbytes(q, kl, vl, bl), 4 * Bo * 32 * So * 80, "f32")
    log(f"K12 BLIP-2 OPT-2.7b decoder [{Bo},32,{So},80] f32 (one layer of the head-major "
        f"cache): kernel {med['kernel']:.4f} ms, plain {o_plain:.4f} ms, library sdpa (boolean "
        f"mask) {med['library']:.4f} ms, sdpa_decode_stale (K12 + the f32 merge) "
        f"{o_merged:.4f} ms, bound {o_bd['bound_ms']:.6f} ms ({o_bd['bound_by']}); in turns "
        f"{turns}; host us per call {host}")
    rec["zoo_shapes"]["BLIP-2 OPT-2.7b decoder"] = dict(
        ms=med["kernel"], plain_ms=o_plain, library_ms=med["library"], merged_ms=o_merged,
        bound_ms=o_bd["bound_ms"], times_in_turns=turns, host_us=host,
        shape=f"q [{Bo},32,1,80], k/v one layer of [4,{Bo},32,{So},80] f32")
    del kc, vc, kl, vl
    rec["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return {"flash_decode": rec}


def ib_cache_len():
    """The cache slots of InstructBLIP's longest phase-19a prompt: the
    queries, the byte ids of '{q} Answer briefly.' and ``ZOO_NEW`` + 1
    beam slots."""
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.blip2 import instructblip_vicuna7b_config
    from cullavo_tpu_torch.pipelines.vl_zoo_pipeline import MODEL_SPECS

    text = max(len(ByteTokenizer().encode(MODEL_SPECS["instructblip"].prompt.format(q=x)))
               for x in VL_QUESTION_TEXT)
    return instructblip_vicuna7b_config().num_query_tokens + text + ZOO_NEW + 1


def opt_cache_len():
    """The cache slots of BLIP-2 OPT's longest phase-21a prompt: the
    queries, the byte ids of 'Question: {q} Answer:' and ``ZOO_NEW`` + 1
    beam slots."""
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.blip2 import Blip2Config
    from cullavo_tpu_torch.pipelines.vl_zoo_pipeline import MODEL_SPECS

    text = max(len(ByteTokenizer().encode(MODEL_SPECS["blip2"].prompt.format(q=x)))
               for x in VL_QUESTION_TEXT)
    return Blip2Config().num_query_tokens + text + ZOO_NEW + 1


def build_params(cfg, device):
    """Phase 4: random LLaVA-1.5-7B weights on the card, int8 SmoothQuant LLM."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import quantize_llm_weights
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params

    g = torch.Generator(device=device).manual_seed(SEED)
    params = init_llava_params(cfg, g, device, dtype=torch.bfloat16)
    D, I = cfg.text.hidden_size, cfg.text.intermediate_size

    def smooth(K):
        return torch.exp(torch.randn((K,), generator=g, device=device) * 0.3)

    s_attn, s_o, s_mlp, s_down = smooth(D), smooth(D), smooth(D), smooth(I)
    scales = {"q": s_attn, "k": s_attn, "v": s_attn, "o": s_o,
              "gate": s_mlp, "up": s_mlp, "down": s_down}
    params = quantize_llm_weights(params, bits=8, smooth_scales=scales)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return params


def cut_layers(params, cfg, n):
    """The model cut to its first ``n`` LLM layers (views of the stacks)."""
    lm = params["language_model"]

    def cut(a):
        return {k: v[:n] for k, v in a.items()} if isinstance(a, dict) else a[:n]

    lm_n = {**lm, "layers": {name: cut(a) for name, a in lm["layers"].items()}}
    return ({**params, "language_model": lm_n},
            dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=n)))


def reference_check(params, cfg, device):
    """Phase 5: the first two LLM layers at full width, kernel path on the
    card vs plain path on the CPU, same weights: prefill (B=2, T=40, one row
    right-padded), one decode step, and a W = 4 window forward with per-row
    write positions over a bf16 and an int8 cache."""
    import torch

    from cullavo_tpu_torch.models.llava.modeling import generate_prefill, llava_forward

    params2, cfg2 = cut_layers(params, cfg, 2)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    g = torch.Generator().manual_seed(SEED + 2)
    B, T, S, W = 2, 40, 48, SPEC_K
    ids = torch.randint(4, 32000, (B, T), generator=g, dtype=torch.int32)
    win = torch.randint(4, 32000, (B, W), generator=g, dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 33:] = 0
    out = {}
    for dev in (device, torch.device("cpu")):
        p = {"language_model": to(params2["language_model"], dev)}
        got = {}
        for kv_quant in (None, "int8"):
            st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S, kv_quant=kv_quant)
            pos = st["cur_pos"][:, None] + torch.arange(W, device=dev)[None]
            # per-row write positions: each row's window starts at its own length
            logits, _ = llava_forward(p, cfg2, win.to(dev), None, None, pos, st["cache"],
                                      st["cur_pos"], st["full_mask"], st["key_pos"],
                                      stale_cache=True)
            got[f"window W={W}, {kv_quant or 'bf16'} cache"] = logits.float().cpu()
        st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S)
        tok = st["logits"].argmax(-1).to(torch.int32)
        logits, _ = llava_forward(p, cfg2, tok[:, None], None, None, st["cur_pos"][:, None],
                                  st["cache"], st["write_idx"], st["full_mask"], st["key_pos"],
                                  stale_cache=True)
        got["prefill"], got["decode"] = st["logits"].float().cpu()[:, None], logits.float().cpu()
        out[dev.type] = got
    worst = 0.0
    for name, a in out["cuda"].items():
        b = out["cpu"][name]
        if a.shape[0] != B or a.shape[2] != cfg.text.vocab_size or not torch.isfinite(a).all():
            raise RuntimeError(f"reference check: bad {name} logits {tuple(a.shape)}")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"reference check ({name} logits, 2 layers at 7B width, card vs CPU): "
            f"max_abs_err={err:.3e}, max |logit| {b.abs().max().item():.3f} (tol 0.1)")
    if not worst <= 0.1:
        raise RuntimeError(f"kernel path disagrees with the plain path: {worst}")


def make_requests(cfg, device):
    """The 14 VQA-shaped requests both paths answer."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 3)
    n_img = cfg.num_image_tokens
    T = 1 + n_img + PROMPT_TEXT
    T_pad = -(-T // PAD_TO) * PAD_TO
    ids = torch.randint(4, 32000, (BATCH, T_pad), generator=g, device=device, dtype=torch.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = torch.ones((BATCH, T_pad), dtype=torch.int32, device=device)
    mask[:, T:] = 0
    side = cfg.vision.image_size
    pix = torch.randn((BATCH, 3, side, side), generator=g, device=device)
    return ids, mask, pix, T, T_pad


def make_run(params, cfg, device, requests, kv_quant=None, spec_k=None):
    """One batch of the 14 requests: plain greedy decode, or speculative
    windows with ``spec_k``; bf16 or int8 KV cache."""
    import torch

    from cullavo_tpu_torch.models.llava.llama import round_cache_len
    from cullavo_tpu_torch.models.llava.modeling import (GenerationConfig, generate_decode,
                                                         generate_decode_spec,
                                                         generate_prefill_chunked)

    ids, mask, pix, _, T_pad = requests
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS, do_sample=False, eos_token_id=-1)
    cache_len = (T_pad + NEW_TOKENS if not spec_k
                 else round_cache_len(T_pad + NEW_TOKENS + spec_k))

    def run(phase=contextlib.nullcontext):
        """``phase(name)`` wraps each phase (e.g. a profiler).  Returns
        (tokens, prefill s, decode s, speculative stats or None)."""
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        with phase("prefill"):
            state = generate_prefill_chunked(params, cfg, ids, pix, mask, cache_len, CHUNK,
                                             compute_dtype=torch.bfloat16, kv_quant=kv_quant)
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        with phase("decode"):
            if spec_k:
                tokens, stats = generate_decode_spec(params, cfg, state, gen, spec_k, ids,
                                                     mask.sum(dim=1),
                                                     compute_dtype=torch.bfloat16)
            else:
                tokens, stats = generate_decode(params, cfg, state, gen,
                                                compute_dtype=torch.bfloat16), None
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        return tokens.cpu(), t1 - t0, t2 - t1, stats

    return run


def replay(params, cfg, device, requests, tokens, kv_quant, chunk=CHUNK, lora=None,
           lora_scaling=0.0, gen=None):
    """Teacher-forced sequential decode: a full prefill, then T = 1
    stale-cache steps fed ``tokens`` [B, N] (with a single adapter set
    ``lora`` when given).  Returns, per position, how far the given token's
    logit lies below the step's maximum (0 where it is the argmax) and the
    step's top-2 gap, both [B, N] on the host; with a sampled ``gen`` also
    how far it lies below the least logit of the step's top-k / top-p set
    (0 inside the set)."""
    import torch

    from cullavo_tpu_torch.models.llava.modeling import (_cast_params, _filter_logits,
                                                         generate_prefill_chunked, llava_forward)
    from cullavo_tpu_torch.models.llava.llama import NEG_INF

    ids, mask, pix, _, T_pad = requests
    lora = _cast_params(lora, torch.bfloat16) if lora else None
    st = generate_prefill_chunked(params, cfg, ids, pix, mask, T_pad + tokens.shape[1], chunk,
                                  compute_dtype=torch.bfloat16, kv_quant=kv_quant, lora=lora,
                                  lora_scaling=lora_scaling)
    toks = tokens.to(device).long()
    cur_pos, write_idx = st["cur_pos"], st["write_idx"]
    below, gap, outside = [], [], []

    def score(logits, i):
        top = torch.topk(logits, 2, dim=-1).values
        mine = logits.gather(1, toks[:, i:i + 1])[:, 0]
        below.append(top[:, 0] - mine)
        gap.append(top[:, 0] - top[:, 1])
        if gen is not None:
            kept = _filter_logits(logits, gen) > NEG_INF / 2
            edge = torch.where(kept, logits, torch.full_like(logits, torch.inf)).amin(dim=-1)
            outside.append((edge - mine).clamp_min(0))

    score(st["logits"], 0)
    for i in range(tokens.shape[1] - 1):
        logits, _ = llava_forward(params, cfg, toks[:, i:i + 1].int(), None, None,
                                  cur_pos[:, None], st["cache"], write_idx, st["full_mask"],
                                  st["key_pos"], stale_cache=True, lora=lora,
                                  lora_scaling=lora_scaling)
        st["full_mask"][:, write_idx] = 1
        st["key_pos"][:, write_idx] = cur_pos
        score(logits[:, 0], i + 1)
        cur_pos, write_idx = cur_pos + 1, write_idx + 1
    out = (torch.stack(below, dim=1).cpu(), torch.stack(gap, dim=1).cpu())
    return out + (torch.stack(outside, dim=1).cpu(),) if gen is not None else out


def check_streams(label, params, cfg, device, requests, kv_quant, tok_spec, tok_greedy):
    """The speculative stream against the greedy one.  In bf16 a window
    forward and a one-token step round at other places (another M in the
    linears; draft keys joined in the window merge, not read back by the
    kernel), so their logits differ by up to about the tolerance phase 5
    holds the kernel path to, and a near-tie of the random-weight logits may
    resolve either way.  Held: every speculative token is the sequential
    step's argmax within ``LOGIT_TOL`` (teacher-forced replay of the
    speculative tokens), and every row whose greedy top-2 gaps all exceed
    ``LOGIT_TOL`` is reproduced token for token."""
    import torch

    below, _ = replay(params, cfg, device, requests, tok_spec, kv_quant)
    self_below, gap = replay(params, cfg, device, requests, tok_greedy, kv_quant)
    same = (tok_spec == tok_greedy).all(dim=1)
    decisive = gap.min(dim=1).values > LOGIT_TOL
    for b in (~same).nonzero().flatten().tolist():
        first = int((tok_spec[b] != tok_greedy[b]).nonzero()[0])
        log(f"{label}: row {b} leaves the greedy stream at position {first} (greedy top-2 gap "
            f"there {gap[b, first]:.4f}, the row's least gap {gap[b].min():.4f}): speculative "
            f"{tok_spec[b].tolist()}, greedy {tok_greedy[b].tolist()}")
    log(f"{label}: {int(same.sum())} of {len(same)} speculative rows equal the greedy stream; "
        f"{int(decisive.sum())} rows have every greedy top-2 gap above {LOGIT_TOL} and "
        f"{int((decisive & same).sum())} of them are equal; worst speculative token lies "
        f"{below.max():.4f} below the sequential step's maximum (tol {LOGIT_TOL}); the replayed "
        f"greedy stream lies {self_below.max():.4f} below")
    if not (below.max() <= LOGIT_TOL and (same | ~decisive).all()):
        raise RuntimeError(f"{label}: the speculative stream is not the greedy stream")
    return int(same.sum())


def check_tokens(tokens, vocab):
    if tokens.shape != (BATCH, NEW_TOKENS) or tokens.min() < 0 or tokens.max() >= vocab:
        raise RuntimeError(f"bad tokens: shape {tuple(tokens.shape)}, "
                           f"range [{tokens.min()}, {tokens.max()}]")


def counted(wrappers, run):
    """Run one batch with every launch count set to 0 just before it and
    read just after."""
    for w in wrappers.values():
        w.launches = 0
    result = run()
    return result, {name: w.launches for name, w in wrappers.items()}


def run_greedy_path(params, cfg, device, requests, wrappers):
    """Phase 6: plain greedy decode over the bf16 cache, twice.  Returns the
    first run's launch counts and the batch function."""
    import torch

    _, _, _, T, T_pad = requests
    run = make_run(params, cfg, device, requests)
    torch.cuda.reset_peak_memory_stats(device)
    (tok1, pre1, dec1, _), counts = counted(wrappers, run)
    log(f"launches on the greedy bf16-cache path: {counts}")
    path = ("flash_fwd", "quant_rows", "int8_linear", "wwin_decode")
    if not all(counts[name] for name in path):
        raise RuntimeError(f"a kernel of the path never launched: {counts}")
    tok2, pre2, dec2, _ = run()
    check_tokens(tok1, cfg.text.vocab_size)
    if not torch.equal(tok1, tok2):
        raise RuntimeError("two runs of the batch gave different tokens")
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    for i, (pre, dec) in enumerate(((pre1, dec1), (pre2, dec2)), 1):
        log(f"greedy run {i}: prefill {pre:.4f} s, decode {dec:.4f} s "
            f"({dec / (NEW_TOKENS - 1) * 1e3:.3f} ms per decode step), "
            f"{BATCH / (pre + dec):.4f} images/s")
    log(f"batch {BATCH}, prompt {T} real tokens padded to {T_pad}, chunk {CHUNK}, "
        f"{NEW_TOKENS} greedy tokens; tokens identical across runs; "
        f"peak memory {peak:.2f} GiB; tokens[0] {tok1[0].tolist()}")
    return counts, run


def run_spec_path(params, cfg, device, requests, wrappers):
    """Phase 6b: int8 KV cache + speculative windows, twice; the int8 greedy
    stream they must reproduce; the bf16 window at a smaller depth.  Returns
    the first run's launch counts and the batch function."""
    import torch

    B, V = BATCH, cfg.text.vocab_size
    run = make_run(params, cfg, device, requests, kv_quant="int8", spec_k=SPEC_K)
    torch.cuda.reset_peak_memory_stats(device)
    (tok1, pre1, dec1, st1), counts = counted(wrappers, run)
    log(f"launches on the speculative int8-cache path: {counts}")
    tok2, pre2, dec2, st2 = run()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    (tok_g, pre_g, dec_g, _), counts_g = counted(
        wrappers, make_run(params, cfg, device, requests, kv_quant="int8"))
    log(f"launches on the greedy int8-cache path: {counts_g}")
    if not (counts["wwin_decode_q8"] and counts_g["wwin_decode_q8"]):
        raise RuntimeError(f"K5 never launched: {counts}, {counts_g}")
    for tok in (tok1, tok_g):
        check_tokens(tok, V)
    if not torch.equal(tok1, tok2) or st1 != st2:
        raise RuntimeError("two speculative runs gave different tokens or counts")
    windows, emitted = st1["windows"], st1["emitted"]
    if not (B <= emitted <= NEW_TOKENS * B
            and -(-(NEW_TOKENS - 1) // SPEC_K) <= windows <= NEW_TOKENS - 1):
        raise RuntimeError(f"inconsistent speculative counts: {st1}")
    if counts["wwin_decode_q8"] != windows * cfg.text.num_hidden_layers:
        raise RuntimeError(f"K5 launches {counts['wwin_decode_q8']} != windows x layers")
    for i, (pre, dec) in enumerate(((pre1, dec1), (pre2, dec2)), 1):
        log(f"speculative run {i}: prefill {pre:.4f} s, decode {dec:.4f} s "
            f"({dec / windows * 1e3:.3f} ms per window), {B / (pre + dec):.4f} images/s")
    log(f"int8 greedy run: prefill {pre_g:.4f} s, decode {dec_g:.4f} s "
        f"({dec_g / (NEW_TOKENS - 1) * 1e3:.3f} ms per decode step), "
        f"{B / (pre_g + dec_g):.4f} images/s")
    # the acceptance formula of generate_decode_spec, per row (a row that
    # reaches its 16 tokens early still counts the later windows: a floor)
    log(f"int8 KV cache, spec_k {SPEC_K}: windows {windows}, emitted {emitted}, "
        f"{(emitted - B) / (windows * B):.3f} tokens per row and window, draft acceptance "
        f"(emitted / B - 1 - windows) / (windows * (spec_k - 1)) = "
        f"{(emitted / B - 1 - windows) / (windows * (SPEC_K - 1)):.3f}; tokens identical "
        f"across runs; peak memory {peak:.2f} GiB; tokens[0] {tok1[0].tolist()}")
    check_streams("int8 cache", params, cfg, device, requests, "int8", tok1, tok_g)

    # the bf16 window (K4 at W = spec_k) at a smaller depth
    params_n, cfg_n = cut_layers(params, cfg, SPEC_BF16_LAYERS)
    (tok_s, _, dec_s, st_s), counts_s = counted(
        wrappers, make_run(params_n, cfg_n, device, requests, spec_k=SPEC_K))
    tok_p = make_run(params_n, cfg_n, device, requests)()[0]
    check_tokens(tok_s, V)
    log(f"bf16 cache, spec_k {SPEC_K}, {SPEC_BF16_LAYERS} layers: {st_s}, "
        f"{dec_s / st_s['windows'] * 1e3:.3f} ms per window, launches {counts_s}")
    if counts_s["wwin_decode"] != st_s["windows"] * SPEC_BF16_LAYERS:
        raise RuntimeError("K4 launches != windows x layers on the bf16 speculative run")
    check_streams(f"bf16 cache, {SPEC_BF16_LAYERS} layers", params_n, cfg_n, device, requests,
                  None, tok_s, tok_p)
    return counts, run


def profile_path(name, run):
    """``--profile``: one more batch under torch.profiler; per phase, the
    device-busy share of the wall time and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    profs = {}

    @contextlib.contextmanager
    def phase(label):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield
        profs[label] = prof

    _, pre, dec, _ = run(phase)
    for label, wall in (("prefill", pre), ("decode", dec)):
        ka = profs[label].key_averages()
        busy = device_seconds(ka)
        log(f"profile {name} {label}: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
            f"({100 * busy / wall:.1f}%)")
        log(ka.table(sort_by="self_device_time_total", row_limit=18,
                     max_name_column_width=70))


def build_nf4_params(cfg, device):
    """Phase 7: random LLaVA-1.5-7B weights on the card with the NF4 base of
    ``MODEL.LLM.BITS: 4``: bf16 everywhere, then the seven LLM targets
    quantized to planar NF4 one at a time (the dense target is released as
    its packed form lands)."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import maybe_quantize_base
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params

    g = torch.Generator(device=device).manual_seed(SEED + 4)
    params = init_llava_params(cfg, g, device, dtype=torch.bfloat16)
    params = maybe_quantize_base(params, SERVE_MODEL_CFG["LLM"]["BITS"])
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    return params


def reference_check_nf4(params, cfg, device, label="NF4"):
    """Phase 5 on the NF4 base: the first two LLM layers at full width, kernel
    path on the card vs plain path on the CPU (a dense matmul against the
    dequantized weight), same weights: a prefill of M = 2 x 264 = 528 rows
    (K7 + a dense matmul on the card), a W = 4 window with per-row write
    positions and a 32-token suffix prefill from row 0's prefix (K6), over
    the int8 cache."""
    import torch

    from cullavo_tpu_torch.models.llava.modeling import (extract_prefix_state,
                                                         generate_prefill,
                                                         generate_prefill_prefix,
                                                         llava_forward)

    params2, cfg2 = cut_layers(params, cfg, 2)

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    g = torch.Generator().manual_seed(SEED + 5)
    B, T, S, W, P, WS = 2, 264, 384, SPEC_K, 224, 32
    ids = torch.randint(4, 32000, (B, T), generator=g, dtype=torch.int32)
    win = torch.randint(4, 32000, (B, W), generator=g, dtype=torch.int32)
    sfx = torch.randint(4, 32000, (B, WS), generator=g, dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 250:] = 0
    smask = torch.ones((B, WS), dtype=torch.int32)
    smask[1, 20:] = 0
    out = {}
    for dev in (device, torch.device("cpu")):
        p = {"language_model": to(params2["language_model"], dev)}
        st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S, kv_quant="int8")
        got = {"prefill M=528": st["logits"].float().cpu()[:, None]}
        prefix = extract_prefix_state(st, 0)
        pos = st["cur_pos"][:, None] + torch.arange(W, device=dev)[None]
        logits, _ = llava_forward(p, cfg2, win.to(dev), None, None, pos, st["cache"],
                                  st["cur_pos"], st["full_mask"], st["key_pos"],
                                  stale_cache=True)
        got[f"window W={W}"] = logits.float().cpu()
        st2 = generate_prefill_prefix(p, cfg2, prefix, sfx.to(dev), None, smask.to(dev), P)
        got[f"suffix prefill P={P} W={WS}"] = st2["logits"].float().cpu()[:, None]
        out[dev.type] = got
    worst = 0.0
    for name, a in out["cuda"].items():
        b = out["cpu"][name]
        if a.shape[0] != B or a.shape[2] != cfg.text.vocab_size or not torch.isfinite(a).all():
            raise RuntimeError(f"{label} reference check: bad {name} logits {tuple(a.shape)}")
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        log(f"{label} reference check ({name} logits, 2 layers at 7B width, int8 cache, card vs "
            f"CPU): max_abs_err={err:.3e}, max |logit| {b.abs().max().item():.3f} (tol 0.1)")
    if not worst <= 0.1:
        raise RuntimeError(f"{label} kernel path disagrees with the plain path: {worst}")


def make_serving_requests(cfg):
    """The serving traffic: 8 random images x 3 questions, image-major.  A
    prompt is bos + 4 text + 576 image + 32 text tokens shared by the
    image's three requests (613), then 8-28 tokens of its own; token budgets
    cycle through 8, 16, 24, 32."""
    import numpy as np

    from cullavo_tpu_torch.serving import Request

    rng = np.random.default_rng(SEED + 6)
    n_img, side = cfg.num_image_tokens, cfg.vision.image_size
    reqs = []
    for im in range(SERVE_IMAGES):
        pix = rng.normal(size=(3, side, side)).astype(np.float32)
        head = rng.integers(4, 32000, size=(1 + SERVE_HEAD_TEXT + n_img + SERVE_SHARED_TEXT,))
        head[0] = 1
        head[1 + SERVE_HEAD_TEXT:1 + SERVE_HEAD_TEXT + n_img] = cfg.image_token_id
        for qn in range(SERVE_QUESTIONS):
            own = rng.integers(4, 32000, size=(int(rng.integers(SERVE_OWN_TEXT[0],
                                                                 SERVE_OWN_TEXT[1] + 1)),))
            i = len(reqs)
            reqs.append(Request(req_id=i, input_ids=np.concatenate([head, own]).astype(np.int32),
                                pixel_values=pix,
                                max_new_tokens=SERVE_BUDGETS[i % len(SERVE_BUDGETS)]))
    return reqs


def make_serving_run(params, cfg, device, reqs):
    """One run of the serving traffic on a fresh engine, built as ``serve``
    builds it: every request submitted, then ``step()`` until all are
    answered.  Returns (results, engine, quanta, wall s)."""
    import torch

    from cullavo_tpu_torch import entry

    def run():
        buckets = SERVE_CFG["PROMPT_BUCKETS"]
        max_len = int(SERVE_CFG.get("MAX_LEN", max(buckets) + max(r.max_new_tokens for r in reqs)))
        _, eng = entry._engine_from_cfg(SERVE_CFG, cfg, params, None, buckets, max_len)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        quanta = 0
        while eng.pending or eng.active:
            eng.step()
            quanta += 1
        torch.cuda.synchronize(device)
        return dict(eng.results), eng, quanta, time.perf_counter() - t0

    return run


def replay_served(params, cfg, device, reqs, results, **kw):
    """``replay`` of the served streams, each request from a FULL prefill of
    its prompt (so prefix reuse, the speculative windows and the slot pool
    are all held).  Returns ``replay``'s tensors and the [n, N] mask of the
    positions each request emitted."""
    import numpy as np
    import torch

    n, T_pad = len(reqs), SERVE_CFG["PROMPT_BUCKETS"][0]
    N = max(len(results[r.req_id]) for r in reqs)
    ids = torch.zeros((n, T_pad), dtype=torch.int32)
    mask = torch.zeros((n, T_pad), dtype=torch.int32)
    toks = torch.zeros((n, N), dtype=torch.int64)
    valid = torch.zeros((n, N), dtype=torch.bool)
    for i, r in enumerate(reqs):
        out = results[r.req_id]
        ids[i, :len(r.input_ids)] = torch.from_numpy(r.input_ids)
        mask[i, :len(r.input_ids)] = 1
        toks[i, :len(out)] = torch.tensor(out)
        toks[i, len(out):] = out[-1]
        valid[i, :len(out)] = True
    pix = torch.from_numpy(np.stack([r.pixel_values for r in reqs])).to(device)
    requests = (ids.to(device), mask.to(device), pix, None, T_pad)
    return replay(params, cfg, device, requests, toks, SERVE_CFG["KV_QUANT"],
                  chunk=SERVE_CFG["PREFILL_CHUNK"], **kw) + (valid,)


def check_serving_streams(params, cfg, device, reqs, results, label="serving", **kw):
    """Every served token against ``replay_served``: the token must be the
    step's argmax within ``LOGIT_TOL`` (with ``lora``, the set the requests
    were served with).  Returns (below, valid)."""
    n = len(reqs)
    below, gap, valid = replay_served(params, cfg, device, reqs, results, **kw)
    worst = below[valid].max().item()
    log(f"{label} replay: worst served token lies {worst:.4f} below the sequential step's "
        f"maximum over {int(valid.sum())} tokens of {n} requests (tol {LOGIT_TOL}); "
        f"{int((gap[valid] <= LOGIT_TOL).sum())} of those steps have a top-2 gap within "
        f"the tolerance")
    if not worst <= LOGIT_TOL:
        raise RuntimeError(f"{label}: a served token is not the sequential step's argmax: "
                           f"{worst}")
    return below, valid


def run_serving_path(params, cfg, device, wrappers):
    """Phase 7: the 24 requests through the engine twice.  Returns the first
    run's launch counts and the run function."""
    import torch

    reqs = make_serving_requests(cfg)
    run = make_serving_run(params, cfg, device, reqs)
    torch.cuda.reset_peak_memory_stats(device)
    (res1, eng, quanta, wall1), counts = counted(wrappers, run)
    log(f"launches on the serving path: {counts}")
    res2, _, _, wall2 = run()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    eos, V = SERVE_CFG["EOS_TOKEN_ID"], cfg.text.vocab_size
    for r in reqs:
        out = res1.get(r.req_id)
        if (not out or len(out) > r.max_new_tokens or min(out) < 0 or max(out) >= V
                or (len(out) < r.max_new_tokens and out[-1] != eos)):
            raise RuntimeError(f"request {r.req_id}: bad result {out} "
                               f"(budget {r.max_new_tokens})")
    if res1 != res2:
        raise RuntimeError("two serving runs gave different tokens")
    n_hit = SERVE_IMAGES * (SERVE_QUESTIONS - 1)
    head = 1 + SERVE_HEAD_TEXT + cfg.num_image_tokens + SERVE_SHARED_TEXT
    want = {"prefix_misses": SERVE_IMAGES, "prefix_hits": n_hit,
            "prefix_tokens_saved": n_hit * (head // 32 * 32)}
    if any(eng.counters[k] != v for k, v in want.items()):
        raise RuntimeError(f"prefix counters {eng.counters} != {want}")
    for name in ("flash_fwd", "wwin_decode_q8", "nf4_linear_planar", "nf4_dequant_planar"):
        if not counts[name]:
            raise RuntimeError(f"{name} never launched on the serving path: {counts}")
    n_tok = sum(len(v) for v in res1.values())
    windows = eng.hist["n_fwd"]
    # tokens that came out of decode windows: all but each request's first
    lat = eng.latency()
    for i, wall in enumerate((wall1, wall2), 1):
        log(f"serving run {i}: {len(reqs)} requests, {n_tok} tokens in {wall:.4f} s: "
            f"{len(reqs) / wall:.4f} requests/s, {n_tok / wall:.3f} tokens/s")
    log(f"serving run 1: TTFT p50 {lat['ttft']['p50']} s p95 {lat['ttft']['p95']} s, E2E p50 "
        f"{lat['e2e']['p50']} s p95 {lat['e2e']['p95']} s; {quanta} scheduler steps, {windows} "
        f"windows of {SERVE_CFG['SPEC_K']}, {(n_tok - len(reqs)) / windows:.3f} tokens per "
        f"forward over the pool; counters {eng.counters}; pool of {eng.num_slots} slots x "
        f"{eng.max_len}; peak memory {peak:.2f} GiB; tokens identical across runs; "
        f"request 0 {res1[0]}")
    check_serving_streams(params, cfg, device, reqs, res1)
    return counts, run


def profile_serving(run):
    """``--profile``: one more serving run under torch.profiler; the
    device-busy share of the wall time and the kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run()
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile serving run: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=24, max_name_column_width=70))


def serve_smoke(device):
    """Phase 7, first: ``entry.serve`` in its smoke mode (tiny random model,
    four synthetic requests, the SERVE block's settings) on the card."""
    import tempfile

    from cullavo_tpu_torch import entry

    with tempfile.TemporaryDirectory() as tmp:
        scfg = {**SERVE_CFG, "PROMPT_BUCKETS": None,
                "RESULTS": os.path.join(tmp, "serve_results.jsonl")}
        summary = entry.serve({"MODEL": {"LLM": {"LOAD_PATH": None, "BITS": 0}}, "SERVE": scfg},
                              device=device)
        with open(scfg["RESULTS"]) as f:
            rows = [json.loads(line) for line in f]
    eos = SERVE_CFG["EOS_TOKEN_ID"]
    if summary["requests"] != 4 or len(rows) != 4 or not all(
            len(r["tokens"]) == 4 + 2 * r["id"]
            or (0 < len(r["tokens"]) < 4 + 2 * r["id"] and r["tokens"][-1] == eos)
            for r in rows):
        raise RuntimeError(f"entry.serve smoke mode: bad results {rows}")
    log(f"entry.serve smoke mode on the card: {summary}")


def _read_lines(stream, sink):
    """Thread body: every line of ``stream`` into the queue ``sink``."""
    for line in iter(stream.readline, ""):
        sink.put(line)
    sink.put(None)


def _http(port, method, path, payload=None, timeout=600):
    """(status, body) of one HTTP call to 127.0.0.1:port: a dict, or the
    lines of a chunked JSONL stream."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, None if payload is None else json.dumps(payload),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    body = r.read().decode()
    conn.close()
    if r.getheader("Content-Type") == "application/jsonl":
        return r.status, [json.loads(line) for line in body.splitlines()]
    return r.status, json.loads(body)


def http_entry_smoke(smi):
    """Phase 18a: ``python -m cullavo_tpu_torch serve --conf_files
    configs/serve.yaml`` with ``SERVE.PORT 0`` in a subprocess (the tiny
    smoke model): the bound port from its stderr line, /healthz, a blocking
    and a streamed POST /generate, /stats with 2 completed, then SIGINT and
    exit 0 within HTTP_EXIT_S."""
    import queue
    import signal
    import threading

    from cullavo_tpu_torch.entry import smoke_llava_config

    mcfg = smoke_llava_config()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_http_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cullavo_tpu_torch", "serve", "--conf_files",
             os.path.join(REPO, "configs", "serve.yaml"), "--overrides", "SERVE.PORT", "0",
             "SERVE.RESULTS", os.path.join(tmp, "unused.jsonl")],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            lines = queue.Queue()
            threading.Thread(target=_read_lines, args=(proc.stderr, lines), daemon=True).start()
            port, seen = None, []
            while port is None:
                line = lines.get(timeout=300)
                if line is None:
                    raise RuntimeError(f"serve exited before binding: {seen[-8:]}")
                seen.append(line.rstrip())
                if line.startswith("[entry] serving on http://"):
                    port = int(line.split("http://", 1)[1].split()[0].rsplit(":", 1)[1])
            t_bound = time.perf_counter() - t0
            if _http(port, "GET", "/healthz") != (200, {"ok": True}):
                raise RuntimeError("serve: /healthz did not answer 200 ok")
            row = {"input_ids": [1, mcfg.image_token_id] + list(range(40, 46)),
                   "image": [[[0.0] * 28] * 28] * 3, "max_new_tokens": 8}
            s1, b1 = _http(port, "POST", "/generate", {**row, "id": 1})
            s2, b2 = _http(port, "POST", "/generate", {**row, "id": 2, "stream": True})
            if s1 != 200 or s2 != 200 or not b1["tokens"] or \
                    [x["token"] for x in b2[:-1]] != b2[-1]["tokens"] or not b2[-1]["done"]:
                raise RuntimeError(f"serve: bad replies {s1} {b1} {s2} {b2}")
            stats = _http(port, "GET", "/stats")[1]
            if stats["completed"] != 2:
                raise RuntimeError(f"serve: /stats {stats}")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
            t_exit = time.perf_counter() - t1
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0 or t_exit > HTTP_EXIT_S:
        raise RuntimeError(f"serve: exit {rc} {t_exit:.2f} s after SIGINT; stderr {seen[-8:]}")
    log(f"phase 18a ({smi}): python -m cullavo_tpu_torch serve bound port {port} after "
        f"{t_bound:.2f} s; /healthz 200; blocking {b1['tokens']}, streamed "
        f"{b2[-1]['tokens']} (text {b1['text']!r}); /stats completed 2; exit 0 "
        f"{t_exit:.2f} s after SIGINT")


def make_adapter_dirs(params, cfg, device, work, smi):
    """Phase 18b: two r = 64 LLM adapter sets (A as ``init_lora_params``
    draws it, B ~ N(0, ADAPTER_B_STD^2)) written with ``save_adapters`` and
    read back bit-equal with ``load_adapters``.  Returns (dirs, sets on the
    card)."""
    import torch

    from cullavo_tpu_torch.checkpoint.store import load_adapters, save_adapters
    from cullavo_tpu_torch.models.llava.lora import LoraConfig, init_lora_params

    lcfg = LoraConfig(r=ADAPTER_R, alpha=ADAPTER_ALPHA)
    dirs, sets = [], []
    t_write = t_read = 0.0
    for k in range(2):
        g = torch.Generator(device=device).manual_seed(SEED + 40 + k)
        lm = init_lora_params(params, cfg, lcfg, g)["language_model"]
        for ab in lm.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g, device=device) * ADAPTER_B_STD
        path = os.path.join(work, f"adapters{k}")
        t0 = time.perf_counter()
        save_adapters(path, {"language_model": lm}, {"r": lcfg.r, "alpha": lcfg.alpha,
                                                     "target_modules": sorted(lm)})
        t1 = time.perf_counter()
        back, acfg = load_adapters(path)
        same = all(torch.equal(back["language_model"][t][n].to(device), a)
                   for t, ab in lm.items() for n, a in ab.items())
        t_read += time.perf_counter() - t1
        t_write += t1 - t0
        if not same or acfg["r"] != lcfg.r or sorted(back) != ["language_model"]:
            raise RuntimeError(f"adapter set {k}: read back unequal ({acfg})")
        dirs.append(path)
        sets.append(lm)
    size = sum(os.path.getsize(os.path.join(d, "adapter_model.safetensors")) for d in dirs)
    log(f"phase 18b ({smi}): two r = {lcfg.r} adapter sets on {len(sets[0])} LLM targets, "
        f"{size / 2**30:.2f} GiB f32 on disk, written in {t_write:.2f} s and read back "
        f"bit-equal in {t_read:.2f} s")
    return dirs, sets


def run_http_path(params, cfg, device, wrappers, smi, dirs, sets, work):
    """Phase 18c: the 24 requests of phase 7 over HTTP at 7B with the two
    sets (adapter ids alternating), from HTTP_CLIENTS client threads; every
    token replayed from a full prefill with the request's own set; the error
    replies; launches counted.  Returns the launch counts."""
    import threading

    import numpy as np
    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.serving import make_server

    reqs = [dataclasses.replace(r, adapter_id=i % 2)
            for i, r in enumerate(make_serving_requests(cfg))]
    buckets = SERVE_CFG["PROMPT_BUCKETS"]
    max_len = max(buckets) + max(r.max_new_tokens for r in reqs)
    scfg = {**SERVE_CFG, "ADAPTERS": dirs}
    _, eng = entry._engine_from_cfg(scfg, cfg, params, None, buckets, max_len)
    if eng._num_adapters != 2:
        raise RuntimeError(f"the engine serves {eng._num_adapters} adapter sets")
    server = make_server(eng, cfg, None, port=0, timeout_s=600.0)
    serving = threading.Thread(target=server.serve_forever, daemon=True)
    serving.start()
    port = server.server_address[1]
    images = {}
    for r in reqs:
        key = id(r.pixel_values)
        if key not in images:
            images[key] = os.path.join(work, f"image{len(images)}.npy")
            np.save(images[key], r.pixel_values)
    rows = [{"id": r.req_id, "input_ids": r.input_ids.tolist(),
             "image": images[id(r.pixel_values)], "max_new_tokens": r.max_new_tokens,
             "adapter_id": r.adapter_id, "stream": i % HTTP_STREAM_EVERY == HTTP_STREAM_EVERY - 1}
            for i, r in enumerate(reqs)]
    replies = {}

    def client(mine):
        for row in mine:
            replies[row["id"]] = _http(port, "POST", "/generate", row)

    def run():
        threads = [threading.Thread(target=client, args=(rows[c::HTTP_CLIENTS],))
                   for c in range(HTTP_CLIENTS)]
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return time.perf_counter() - t0

    wall, counts = counted(wrappers, run)
    results, n_stream = {}, 0
    for row in rows:
        status, body = replies[row["id"]]
        if status != 200:
            raise RuntimeError(f"HTTP request {row['id']}: {status} {body}")
        if row["stream"]:
            n_stream += 1
            if not body[-1].get("done") or [x["token"] for x in body[:-1]] != body[-1]["tokens"]:
                raise RuntimeError(f"HTTP stream {row['id']}: lines disagree: {body[-3:]}")
            body = body[-1]
        results[row["id"]] = body["tokens"]
    stats = _http(port, "GET", "/stats")[1]
    sched = stats["scheduler"]
    if stats["completed"] != len(reqs) or sched["prefix_hits"] + sched["prefix_misses"] != \
            len(reqs) or sched["prefix_misses"] < 2 * SERVE_IMAGES:
        raise RuntimeError(f"HTTP /stats: {stats}")
    for name in ("flash_fwd", "wwin_decode_q8", "nf4_linear_planar", "nf4_dequant_planar"):
        if not counts[name]:
            raise RuntimeError(f"{name} never launched on the HTTP path: {counts}")
    # the refusals, on the same server
    errors = {}
    for label, payload in (("over-long prompt", {"id": 900, "input_ids": [1] * 700,
                                                 "max_new_tokens": 4}),
                           ("adapter_id 2", {**rows[0], "id": 901, "adapter_id": 2,
                                             "stream": False})):
        errors[label] = _http(port, "POST", "/generate", payload)
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/generate", json.dumps({**rows[3], "id": 902, "stream": True,
                                                  "max_new_tokens": 32}))
    flowing = conn.getresponse()                  # headers back: 902 is admitted
    errors["duplicate id"] = _http(port, "POST", "/generate",
                                   {**rows[3], "id": 902, "stream": False})
    flowing.read()
    conn.close()
    errors["unknown path"] = _http(port, "GET", "/nope")
    want = {"over-long prompt": (400, "bucket"), "adapter_id 2": (400, "adapter_id 2"),
            "duplicate id": (400, "duplicate req_id 902"), "unknown path": (404, "unknown path")}
    for label, (code, word) in want.items():
        status, body = errors[label]
        if status != code or word not in body["error"]:
            raise RuntimeError(f"HTTP {label}: {status} {body}")
    server.shutdown()
    server.runner.stop()
    server.server_close()
    serving.join(10)
    n_tok = sum(len(v) for v in results.values())
    log(f"phase 18c HTTP ({smi}): {len(reqs)} requests ({n_stream} streamed, adapters 0 / 1) "
        f"from {HTTP_CLIENTS} clients, {n_tok} tokens in {wall:.4f} s: "
        f"{len(reqs) / wall:.4f} requests/s, {n_tok / wall:.3f} tokens/s; /stats TTFT p50 "
        f"{stats['ttft_s']['p50']} s p95 {stats['ttft_s']['p95']} s, E2E p50 "
        f"{stats['e2e_s']['p50']} s p95 {stats['e2e_s']['p95']} s; counters {sched}; "
        f"400 / 404 as expected: {sorted(want)}; launches {counts}")
    # every token against its own set's replay; how many streams the other set
    # would not have chosen
    other = {}
    for k in range(2):
        mine = [r for r in reqs if r.adapter_id == k]
        check_serving_streams(params, cfg, device, mine, results, label=f"HTTP adapter {k}",
                              lora={"language_model": sets[k]},
                              lora_scaling=ADAPTER_ALPHA / ADAPTER_R)
        below, _, valid = replay_served(params, cfg, device, mine, results,
                                        lora={"language_model": sets[1 - k]},
                                        lora_scaling=ADAPTER_ALPHA / ADAPTER_R)
        for i, r in enumerate(mine):
            other[r.req_id] = below[i][valid[i]].max().item()
    differ = sum(v > LOGIT_TOL for v in other.values())
    log(f"HTTP adapters: {differ} of {len(reqs)} streams hold a token more than {LOGIT_TOL} "
        f"below the other set's step maximum (worst per request "
        f"{[round(other[r.req_id], 3) for r in reqs]})")
    if 2 * differ <= len(reqs):
        raise RuntimeError("the two adapter sets' streams agree on most requests")
    return counts


def run_sampled_serving(params, cfg, device, wrappers, smi, dirs, sets):
    """Phase 18d: ``DO_SAMPLE: true`` on the same block (SPEC_K switched
    off): the 24 requests offline twice on fresh engines from one seed,
    identical tokens; every drawn token inside its filtered set of a
    teacher-forced replay (within SAMPLE_MARGIN); K5 at W = 1 (and at the
    suffix prefills' widths)."""
    import io

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.models.llava import llama as llama_mod

    reqs = [dataclasses.replace(r, adapter_id=i % 2)
            for i, r in enumerate(make_serving_requests(cfg))]
    buckets = SERVE_CFG["PROMPT_BUCKETS"]
    max_len = max(buckets) + max(r.max_new_tokens for r in reqs)
    scfg = {**SERVE_CFG, "ADAPTERS": dirs, "DO_SAMPLE": True}
    widths = collections.Counter()
    k5 = llama_mod.wwin_decode_smajor_q8

    def recording(qh, *a, **kw):
        widths[qh.shape[2]] += 1
        return k5(qh, *a, **kw)

    def run():
        said = io.StringIO()
        with contextlib.redirect_stderr(said):
            gen, eng = entry._engine_from_cfg(scfg, cfg, params, None, buckets, max_len)
        if eng.spec_k is not None or "disables speculative decoding" not in said.getvalue():
            raise RuntimeError(f"DO_SAMPLE: SPEC_K stayed on ({said.getvalue()!r})")
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for r in reqs:
            eng.submit(r)
        res = eng.run()
        torch.cuda.synchronize(device)
        return dict(res), gen, time.perf_counter() - t0

    llama_mod.wwin_decode_smajor_q8 = recording
    (res1, gen, wall1), counts = counted(wrappers, run)
    llama_mod.wwin_decode_smajor_q8 = k5
    res2, _, wall2 = run()
    if res1 != res2:
        raise RuntimeError("two sampled serving runs from one seed gave different tokens")
    if not widths[1] or set(widths) - {1, *SERVE_SUFFIX_W}:
        raise RuntimeError(f"sampled serving: K5 window widths {dict(widths)}")
    worst = 0.0
    for k in range(2):
        mine = [r for r in reqs if r.adapter_id == k]
        _, _, outside, valid = replay_served(params, cfg, device, mine, res1,
                                             lora={"language_model": sets[k]},
                                             lora_scaling=ADAPTER_ALPHA / ADAPTER_R, gen=gen)
        worst = max(worst, outside[valid].max().item())
    n_tok = sum(len(v) for v in res1.values())
    log(f"phase 18d sampled ({smi}): temperature {gen.temperature}, top-k {gen.top_k}, top-p "
        f"{gen.top_p}, seed 0; {len(reqs)} requests twice, tokens identical; {n_tok} tokens in "
        f"{wall1:.4f} / {wall2:.4f} s = {n_tok / wall1:.3f} / {n_tok / wall2:.3f} tokens/s; "
        f"K5 launches by window width {dict(widths)}; worst drawn token {worst:.4f} below its "
        f"filtered set's least logit in the replay (margin {SAMPLE_MARGIN}); launches {counts}")
    if not worst <= SAMPLE_MARGIN:
        raise RuntimeError(f"a sampled token lies outside its top-k / top-p set: {worst}")
    return counts


def time_quanta(params, cfg, device, smi, dirs):
    """Phase 18e: ms per quantum (and per speculative forward) over the same
    pool, greedy, without adapters and with the two-set stack: the 24
    requests offline, every quantum timed with the card synchronized."""
    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.serving import engine as engine_mod

    reqs = [dataclasses.replace(r, adapter_id=i % 2)
            for i, r in enumerate(make_serving_requests(cfg))]
    buckets = SERVE_CFG["PROMPT_BUCKETS"]
    max_len = max(buckets) + max(r.max_new_tokens for r in reqs)
    quantum = engine_mod.decode_quantum_spec
    out = {}
    for label, scfg, rows in (("no adapters", SERVE_CFG,
                               [dataclasses.replace(r, adapter_id=0) for r in reqs]),
                              ("two-set stack", {**SERVE_CFG, "ADAPTERS": dirs}, reqs)):
        spans = []

        def timed(*a, **kw):
            torch.cuda.synchronize(device)
            n0, t0 = int(a[3].get("n_fwd", 0)), time.perf_counter()
            got = quantum(*a, **kw)
            torch.cuda.synchronize(device)
            spans.append((time.perf_counter() - t0, got[3]["n_fwd"] - n0))
            return got

        _, eng = entry._engine_from_cfg(scfg, cfg, params, None, buckets, max_len)
        engine_mod.decode_quantum_spec = timed
        for r in rows:
            eng.submit(r)
        eng.run()
        engine_mod.decode_quantum_spec = quantum
        ms = sorted(1e3 * s for s, _ in spans)
        out[label] = (statistics.median(ms), 1e3 * sum(s for s, _ in spans)
                      / sum(n for _, n in spans), len(spans))
        del eng
    log(f"phase 18e quanta ({smi}), {SERVE_CFG['SLOTS']} slots, quantum "
        f"{SERVE_CFG['QUANTUM']}, windows of {SERVE_CFG['SPEC_K']}: "
        + "; ".join(f"{k}: median {v[0]:.3f} ms per quantum, {v[1]:.3f} ms per forward over "
                    f"{v[2]} quanta" for k, v in out.items()))


def profile_adapter_stack(params, cfg, device, sets, smi, n=4):
    """``--profile``: the stale-cache decode forward over SLOTS rows (after
    a 32-token text prefill into the SERVE block's cache) without adapters,
    with one set and with the two-set stack (rows alternating): first the
    wall of ``n`` forwards each unprofiled, then ``n`` each under
    torch.profiler for the device-busy time and the device launches a
    forward; the stack's kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cullavo_tpu_torch.models.llava import modeling as tm
    from cullavo_tpu_torch.models.llava.lora import stack_adapter_sets

    B, T = SERVE_CFG["SLOTS"], 32
    g = torch.Generator(device=device).manual_seed(SEED + 50)
    ids = torch.randint(4, 32000, (B, T), generator=g, device=device, dtype=torch.int32)
    bf16 = torch.bfloat16
    lm = tm._cast_params(params, bf16)
    forms = {"no adapters": (None, None),
             "one set": (tm._cast_params({"language_model": sets[0]}, bf16), None),
             "two-set stack": (tm._cast_params({"language_model": stack_adapter_sets(sets)},
                                               bf16),
                               torch.arange(B, device=device, dtype=torch.int32) % 2)}
    with torch.no_grad():
        st = tm.generate_prefill(lm, cfg, ids, None, torch.ones_like(ids), 2 * T,
                                 kv_quant=SERVE_CFG["KV_QUANT"])
    tok = torch.argmax(st["logits"], dim=-1).to(torch.int32)[:, None]

    def forwards(lora, aid):
        with torch.no_grad():
            for _ in range(n):
                tm.llava_forward(lm, cfg, tok, None, None, st["cur_pos"][:, None], st["cache"],
                                 T, st["full_mask"], st["key_pos"], stale_cache=True, lora=lora,
                                 lora_scaling=ADAPTER_ALPHA / ADAPTER_R, adapter_ids=aid)
        torch.cuda.synchronize(device)

    walls = {}
    for label, form in forms.items():      # unprofiled first: the profiler slows launches
        forwards(*form)
        t0 = time.perf_counter()
        forwards(*form)
        walls[label] = (time.perf_counter() - t0) / n
    for label, form in forms.items():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            forwards(*form)
            wall = (time.perf_counter() - t0) / n
        ka = prof.key_averages()
        launches = sum(e.count for e in ka if e.device_type == DeviceType.CUDA) / n
        log(f"profile adapters, {label} ({smi}): a {B}-row decode forward {1e3 * walls[label]:.3f} "
            f"ms unprofiled, {1e3 * wall:.3f} ms profiled, device busy "
            f"{1e3 * device_seconds(ka) / n:.3f} ms, {launches:.0f} device launches")
    log(ka.table(sort_by="self_device_time_total", row_limit=14, max_name_column_width=70))


def run_serving_rest(params, cfg, device, wrappers, smi, profile=False):
    """Phase 18: the HTTP entry point, adapter files, HTTP at 7B with two
    adapter sets, sampled serving, the quanta timed.  Returns the HTTP run's
    launch counts and, with ``profile``, a callable that runs
    ``profile_adapter_stack`` on the same sets (else None)."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(device)
    http_entry_smoke(smi)
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_adapters_") as work:
        dirs, sets = make_adapter_dirs(params, cfg, device, work, smi)
        counts = run_http_path(params, cfg, device, wrappers, smi, dirs, sets, work)
        run_sampled_serving(params, cfg, device, wrappers, smi, dirs, sets)
        time_quanta(params, cfg, device, smi, dirs)
    later = (functools.partial(profile_adapter_stack, params, cfg, device, sets, smi)
             if profile else None)
    del sets
    torch.cuda.empty_cache()
    log(f"phase 18 ({smi}): {time.perf_counter() - t0:.1f} s; peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    return counts, later


def train_smoke(device):
    """Phase 8, first: ``entry.train`` in its smoke mode (tiny random model
    over an NF4 base, one Q-LoRA step on two synthetic records) on the card."""
    import math

    from cullavo_tpu_torch import entry

    metrics = entry.train(TRAIN_CFG, device=device)
    if not (math.isfinite(metrics["loss_llm"]) and 0 < metrics["grad_norm"] < math.inf):
        raise RuntimeError(f"entry.train smoke mode: bad metrics {metrics}")
    log(f"entry.train smoke mode on the card: {metrics}")


def _capture_tx():
    """An optimizer that moves nothing and keeps the gradients as its state."""
    import torch

    from cullavo_tpu_torch.trainer.optimizer import GradientTransformation
    from cullavo_tpu_torch.utils.tree import tree_map

    return GradientTransformation(lambda p: tree_map(torch.zeros_like, p),
                                  lambda g, s, p: (tree_map(torch.zeros_like, g), g))


def reference_check_train(params, cfg, device):
    """Phase 8: the Q-LoRA train step at full width and small depth, kernel
    path on the card against plain path on the CPU from one state: 2 LLM
    layers, 3 vision layers on a 112 x 112 image (64 image tokens), batch 2
    right-padded to T = 264 (M = 528: K7 and K1-lse on the card), r = 64
    adapters with random non-zero ``b``, remat, bf16 compute over f32
    masters, chunked loss, no dropout.  Held: the loss within 2e-2 relative
    and every gradient leaf (LoRA, projector, embed_tokens, lm_head) within
    5e-2 of the CPU leaf's largest entry (bf16 rounds at other places on the
    two devices)."""
    import torch

    from cullavo_tpu_torch.models.llava import lora as lora_mod
    from cullavo_tpu_torch.trainer.step import TrainState, make_train_step
    from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map

    params2, cfg2 = cut_layers(params, cfg, 2)
    n_vis, side = 3, 112
    vcfg = dataclasses.replace(cfg.vision, num_hidden_layers=n_vis, image_size=side)
    cfg2 = dataclasses.replace(cfg2, vision=vcfg)
    vt = params2["vision_tower"]
    params2 = {**params2, "vision_tower": {
        **vt, "position_embedding": vt["position_embedding"][:vcfg.num_positions],
        "layers": {k: a[:n_vis] for k, a in vt["layers"].items()}}}
    lcfg = lora_mod.LoraConfig(r=64, alpha=16.0, dropout=0.0, vision_layer_start=0,
                               vision_layer_stop=2)
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    lora = lora_mod.init_lora_params(params2, cfg2, lcfg, g)
    for tower in lora.values():
        for ab in tower.values():
            ab["b"] = torch.randn(ab["b"].shape, generator=g, device=device) * 0.01
    trainable = tree_map(lambda t: t.float(), lora_mod.trainable_partition(params2, lora))
    frozen = lora_mod.strip_trainable(params2)

    gc = torch.Generator().manual_seed(SEED + 8)
    B, T, n_img = 2, 264, cfg2.num_image_tokens
    ids = torch.randint(4, 32000, (B, T), generator=gc, dtype=torch.int32)
    ids[:, 1:1 + n_img] = cfg2.image_token_id
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, 250:] = 0
    labels = torch.where(mask != 0, ids, -100)
    labels[:, :1 + n_img + 8] = -100
    batch = {"input_ids": ids, "attention_mask": mask, "labels": labels,
             "pixel_values": torch.randn((B, 3, side, side), generator=gc),
             "weights": torch.tensor([1.0, 0.5])}
    step = make_train_step(cfg2, lcfg, _capture_tx(), remat=True, compute_dtype=torch.bfloat16,
                           loss_chunk=64)
    out = []
    for dev in (device, torch.device("cpu")):
        move = lambda t: t.to(dev)   # noqa: E731
        st, met = step(TrainState(tree_map(move, trainable), None, 0), tree_map(move, frozen),
                       tree_map(move, batch), None)
        out.append((float(met["loss_llm"]), float(met["grad_norm"]),
                    tree_map(lambda t: t.float().cpu(), st.opt_state)))
    (loss_c, norm_c, g_c), (loss_p, norm_p, g_p) = out
    log(f"train-step check (2 LLM + {n_vis} vision layers at 7B width, card vs CPU): loss "
        f"{loss_c:.5f} vs {loss_p:.5f} (tol 2e-2 relative), grad_norm {norm_c:.5f} vs "
        f"{norm_p:.5f}")
    if not abs(loss_c - loss_p) <= 2e-2 * abs(loss_p):
        raise RuntimeError(f"train-step check: loss {loss_c} vs {loss_p}")

    def named(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from named(v, f"{prefix}{k}/")
            elif v is not None and k != "mask":
                yield prefix + k, v

    worst = ("", 0.0)
    for (name, a), (_, b) in zip(named(g_c), named(g_p)):
        top = b.abs().max().item()
        rel = (a - b).abs().max().item() / top
        worst = max(worst, (name, rel), key=lambda x: x[1])
        if not (torch.isfinite(a).all() and top > 0 and rel <= 5e-2):
            raise RuntimeError(f"train-step check: gradient {name} differs by {rel:.3e} of its "
                               f"largest entry {top:.3e}")
    log(f"train-step check: {len(tree_leaves(g_p))} gradient leaves; the worst, {worst[0]}, "
        f"differs by {worst[1]:.3e} of its largest entry (tol 5e-2)")


def make_train_batch(cfg, device):
    """The train batch: 8 rows right-padded to T = 1024, real lengths spread
    over 700-1024, 576 image tokens after bos, 336 x 336 pixels, labels on
    the text after the first 8 text tokens, weights 1."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED + 9)
    B, T, n_img = TRAIN_CFG["BATCH_SIZE"], TRAIN_T, cfg.num_image_tokens
    lo, hi = TRAIN_LEN_RANGE
    lengths = torch.linspace(lo, hi, B).round().long().to(device)
    ids = torch.randint(4, 32000, (B, T), generator=g, device=device, dtype=torch.int32)
    ids[:, 1:1 + n_img] = cfg.image_token_id
    mask = (torch.arange(T, device=device)[None, :] < lengths[:, None]).int()
    labels = torch.where(mask != 0, ids, -100)
    labels[:, :1 + n_img + 8] = -100
    side = cfg.vision.image_size
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "pixel_values": torch.randn((B, 3, side, side), generator=g, device=device),
            "weights": torch.ones((B,), device=device)}, int(lengths.sum())


def _base_digest(frozen):
    """Sums over the frozen base, leaf by leaf: equal digests mean the step
    changed no frozen bit (int32 words summed exactly, floats as their bits)."""
    import torch

    def digest(t):
        if t.dtype.is_floating_point:
            t = t.view(torch.int16 if t.element_size() == 2 else torch.int32)
        return int(t.long().sum().item())

    out = []

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif v is not None:
                out.append(digest(v))

    walk(frozen)
    return out


def run_train_path(params_nf4, cfg, device, wrappers):
    """Phase 8: 4 Q-LoRA steps at the full width and depth of LLaVA-1.5-7B
    over the NF4 base, twice from the same seed.  Returns the first run's
    launch counts, the pipeline and the batch."""
    import math

    import torch

    from cullavo_tpu_torch.pipelines.base import build_pipeline
    from cullavo_tpu_torch.utils.tree import tree_leaves, tree_map

    # the masters of the trainable full modules are f32
    lm = params_nf4["language_model"]
    params = {**params_nf4,
              "projector": tree_map(lambda t: t.float(), params_nf4["projector"]),
              "language_model": {**lm, "embed_tokens": lm["embed_tokens"].float(),
                                 "lm_head": lm["lm_head"].float()}}
    pipe = build_pipeline(TRAIN_CFG["PIPELINE"], TRAIN_CFG, model_cfg=cfg, tokenizer=None,
                          params=params)
    batch, n_real = make_train_batch(cfg, device)
    B, T, L = TRAIN_CFG["BATCH_SIZE"], TRAIN_T, cfg.text.num_hidden_layers

    def run(steps=TRAIN_STEPS):
        state = pipe.initialize_model()
        rng = torch.Generator().manual_seed(SEED)
        losses, norms, secs = [], [], []
        for _ in range(steps):
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, met = pipe.forward_step(state, batch, rng)
            torch.cuda.synchronize(device)
            secs.append(time.perf_counter() - t0)
            losses.append(float(met["loss_llm"]))
            norms.append(float(met["grad_norm"]))
        return state, losses, norms, secs

    state0 = pipe.initialize_model()
    n_train = sum(t.numel() for t in tree_leaves(state0.trainable))
    log(f"train state: {n_train / 1e6:.1f} M trainable parameters (r = {pipe.lora_cfg.r} "
        f"adapters on {len(state0.trainable['lora']['language_model'])} LLM targets and "
        f"{len(state0.trainable['lora']['vision_tower'])} vision targets, projector, lm_head, "
        f"embed_tokens), f32 masters, {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
        "allocated with the NF4 base")
    del state0
    before = _base_digest(pipe.frozen)
    torch.cuda.reset_peak_memory_stats(device)
    (state, losses, norms, secs), counts = counted(wrappers, run)
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    log(f"launches on the train path: {counts}")
    _, losses2, norms2, secs2 = run(2)      # the first 2 steps again (to pay for phase 23)
    if _base_digest(pipe.frozen) != before:
        raise RuntimeError("the train step changed the frozen base")
    if not all(math.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise RuntimeError(f"train path: bad losses {losses} or grad norms {norms}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"train path: the loss did not fall: {losses}")
    drift = max(abs(a - b) / abs(a) for a, b in zip(losses[:2] + norms[:2], losses2 + norms2))
    log(f"two runs from one seed: losses {losses} and {losses2}; equal bit for bit: "
        f"{losses[:2] == losses2 and norms[:2] == norms2}; largest relative difference {drift:.3e} "
        "(tol 1e-3: cuBLAS may pick another split of a reduction between runs)")
    if not drift <= 1e-3:
        raise RuntimeError(f"train path: two runs from one seed differ by {drift}")
    # per step: every layer's attention runs in the forward and again in the
    # rematerialized backward; every NF4 linear dequantizes there and once
    # more for dx (M = 8192 is above the fused kernel's threshold)
    want = {"flash_fwd_lse": TRAIN_STEPS * 2 * L, "nf4_dequant_planar": TRAIN_STEPS * 3 * 7 * L,
            "nf4_linear_planar": 0, "flash_fwd": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"train path: launches {counts} != predicted {want}")
    if state.step != TRAIN_STEPS or state.opt_state["count"] != TRAIN_STEPS:
        raise RuntimeError(f"train path: step count {state.step}")
    for i, sec in enumerate((secs, secs2), 1):
        med = statistics.median(sec[1:])
        log(f"train run {i}: s per step {[round(x, 4) for x in sec]}, median of steps 2-"
            f"{len(sec)} {med:.4f} s: {B * T / med:.1f} padded tokens/s, "
            f"{n_real / med:.1f} real tokens/s")
    log(f"batch {B} x T {T} ({n_real} real tokens), NF4 base, r 64, remat, bf16 compute, loss "
        f"chunk 256, dropout 0.05: losses {[round(x, 5) for x in losses]}, grad_norm "
        f"{[round(x, 4) for x in norms]}, peak memory {peak:.2f} GiB")
    return counts, pipe, batch


def profile_train(pipe, batch, device):
    """``--profile``: one warm step, then one step under torch.profiler; the
    device-busy share of the wall time and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state = pipe.initialize_model()
    rng = torch.Generator().manual_seed(SEED)
    state, _ = pipe.forward_step(state, batch, rng)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe.forward_step(state, batch, rng)
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile train step: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=30, max_name_column_width=70))


def run_attn_probe(device, wrappers):
    """Phase 8b: the package's attention probe at its default shape: plain
    attention against ``flash_attention`` with explicit positions and a key
    mask (K8), 8 layers.  Returns the launch counts of its run."""
    from cullavo_tpu_torch.scripts import attn_probe

    rows, counts = counted(wrappers, lambda: attn_probe.probe(device, *PROBE_SHAPE[::2], 8))
    by = {r["variant"]: r for r in rows}
    log(f"attn_probe B={PROBE_SHAPE[0]} T={PROBE_SHAPE[2]}: plain {by['sdpa']['ms_per_layer']} "
        f"ms per layer, flash_attention (K8) {by['flash']['ms_per_layer']} ms per layer; "
        f"launches {counts}")
    # one call for the comparison, then a warm-up and 4 timed passes over 8 layers
    if counts["flash_rows"] != 1 + 5 * 8:
        raise RuntimeError(f"attn_probe: K8 launches {counts['flash_rows']} != 41")
    return counts


def _tree_to(node, **kw):
    """An X-Decoder parameter tree (nested dicts and lists of tensors) with
    ``.to(**kw)`` applied to every leaf."""
    if isinstance(node, dict):
        return {k: _tree_to(v, **kw) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, **kw) for v in node]
    return node.to(**kw)


def xdecoder_entry_smoke(device):
    """Phase 9a: ``entry.evaluate`` on configs/xdecoder_test.yaml with
    ``DATASETS.TEST`` unset: the full model's random weights and the text
    tokenizer are built on the card, and the result is ``{}`` as in JAX."""
    from cullavo_tpu_torch import entry

    t0 = time.perf_counter()
    results = entry.evaluate(XDEC_CONFIGS[XDEC_FOCAL], device=device)
    if results != {}:
        raise RuntimeError(f"entry.evaluate({XDEC_FOCAL}): {results}, not {{}}")
    log(f"entry.evaluate({XDEC_FOCAL}) on the card: {results} in "
        f"{time.perf_counter() - t0:.1f} s")


def xdecoder_cut(path):
    """The config of ``path`` at full width with its depth cut: one block
    per FocalNet stage and one FPN encoder layer, or two SAM-ViT blocks (the
    second global) and one deformable layer; 2 decoder and 2 text layers."""
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from

    full = xdecoder_model_config_from(XDEC_CONFIGS[path])
    if path == XDEC_FOCAL:
        backbone = dataclasses.replace(full.backbone, depths=(1, 1, 1, 1))
        encoder = dataclasses.replace(full.fpn, enc_layers=1)
    else:
        backbone = dataclasses.replace(full.backbone, depth=2, global_attn_indexes=(1,))
        encoder = dataclasses.replace(full.fpn, num_layers=1)
    return dataclasses.replace(full, backbone=backbone, fpn=encoder,
                               decoder=dataclasses.replace(full.decoder, dec_layers=2),
                               text=dataclasses.replace(full.text, layers=2))


def reference_check_xdecoder(device, wrappers):
    """Phase 9b: each configuration at full width and cut depth, f32, on one
    256 x 320 image, kernels on the card against the plain versions on the
    CPU (same weights, drawn on the CPU): class embeddings of 8 classes and
    the background, the class and mask logits of ``forward_eval`` within
    1e-3 of their largest entry (TF32 off; a mask logit near 0 can flip a
    cross-attention bit between the two)."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.entry import _make_text_tokenize
    from cullavo_tpu_torch.models.xdecoder.model import forward_eval, init_xdecoder_model_params
    from cullavo_tpu_torch.models.xdecoder.text_encoder import class_embeddings_ensembled
    from cullavo_tpu_torch.utils.constants import COCO_PANOPTIC_CLASSES

    h, w = XDEC_CHECK_HW
    image = np.random.default_rng(SEED).normal(size=(1, h, w, 3)).astype(np.float32)
    for path in XDEC_CONFIGS:
        cfg = xdecoder_cut(path)
        tokenize = _make_text_tokenize(XDEC_CONFIGS[path], cfg.text)
        params = init_xdecoder_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
        outs = []
        for dev in (torch.device("cpu"), device):
            p = _tree_to(params, device=dev)

            def run():
                with torch.inference_mode():
                    emb = class_embeddings_ensembled(p["text"], cfg.text, tokenize,
                                                     COCO_PANOPTIC_CLASSES[:8],
                                                     add_background=True)
                    return (emb,) + forward_eval(p, cfg, torch.as_tensor(image, device=dev),
                                                 emb)[:2]

            got, counts = counted(wrappers, run)
            outs.append([t.float().cpu() for t in got])
        worst = []
        for name, b, a in zip(("class embeddings", "pred_logits", "pred_masks"), *outs):
            rel = ((a - b).abs().max() / b.abs().max()).item()
            worst.append(rel)
            log(f"{path} cut ({h}x{w}, f32) {name} {tuple(a.shape)}: card vs CPU "
                f"max |d| / max |ref| = {rel:.3e} (tol 1e-3)")
        need = "focal_ctx" if path == XDEC_FOCAL else "ms_deform_attn"
        if not (max(worst) <= 1e-3 and counts[need]):
            raise RuntimeError(f"{path}: the card's cut model disagrees with the CPU's "
                               f"({worst}) or {need} never launched ({counts})")


def _rle_counts(mask):
    """Uncompressed COCO RLE runs of a boolean [H, W] mask (column-major,
    starting with a run of zeros)."""
    import numpy as np

    flat = np.asarray(mask, bool).T.reshape(-1).astype(np.int8)
    edges = np.flatnonzero(np.diff(np.concatenate([[0], flat, [1 - flat[-1]]])))
    return np.diff(np.concatenate([[0], edges])).tolist()


def write_joint_dataset(root, sizes, class_names, n_things, seed=0, captions=5):
    """A COCO-format panoptic + caption + grounding dataset of random images
    under ``root``, written with the port's PNG writer: per image of
    ``sizes`` a PNG (named ``.jpg``, as the panoptic loader names it), an
    id-encoded panoptic PNG with a stuff segment, three thing rectangles
    and one crowd rectangle, ``captions`` captions, and two grounding
    annotations (a polygon and an uncompressed RLE, two sentences and
    one).  Category ids are 2 i + 1 (the first ``n_things`` are things).
    Returns the ``DATASETS.REGISTER`` entry of kind
    ``coco_panoptic_caption_grounding``."""
    import numpy as np

    from cullavo_tpu_torch.data import png_io
    from cullavo_tpu_torch.data.coco_panoptic import id2rgb

    rng = np.random.default_rng(seed)
    img_dir, pan_dir = os.path.join(root, "images"), os.path.join(root, "panoptic")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pan_dir, exist_ok=True)
    cats = [{"id": 2 * i + 1, "name": n, "isthing": int(i < n_things)}
            for i, n in enumerate(class_names)]
    pan_anns, cap_anns, grd_anns = [], [], []
    for k, (H, W) in enumerate(sizes):
        ids = np.zeros((H, W), np.int64)
        stuff = int(rng.integers(n_things, len(class_names)))
        ids[int(0.6 * H):] = 1
        segs = [{"id": 1, "category_id": cats[stuff]["id"], "iscrowd": 0}]
        rects, things = [], []
        for j in range(4):
            h, w = int(rng.integers(H // 6, H // 3)), int(rng.integers(W // 6, W // 3))
            y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
            ids[y:y + h, x:x + w] = 2 + j
            thing = int(rng.integers(0, n_things))
            segs.append({"id": 2 + j, "category_id": cats[thing]["id"], "iscrowd": int(j == 3)})
            rects.append((x, y, w, h))
            things.append(class_names[thing])
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        name = f"{k:012d}"
        png_io.write_png(os.path.join(img_dir, name + ".jpg"), img)
        png_io.write_png(os.path.join(pan_dir, name + ".png"), id2rgb(ids))
        pan_anns.append({"image_id": k, "file_name": name + ".png", "segments_info": segs})
        sname = class_names[stuff]
        for c in range(captions):
            cap_anns.append({"image_id": k, "id": k * captions + c,
                             "caption": f"a {things[c % 3]} sitting near the {sname} with "
                                        f"{c + 1} lamps and a wooden fence"})
        x, y, w, h = rects[0]
        grd_anns.append({"image_id": k, "id": 2 * k, "height": H, "width": W,
                         "category_id": segs[1]["category_id"],
                         "segmentation": [[x, y, x + w, y, x + w, y + h, x, y + h]],
                         "sentences": [{"raw": f"The {things[0]} on the left"},
                                       {"raw": f"a {things[0]}"}]})
        grd_anns.append({"image_id": k, "id": 2 * k + 1, "height": H, "width": W,
                         "category_id": segs[0]["category_id"],
                         "segmentation": {"counts": _rle_counts(ids == 1), "size": [H, W]},
                         "sentences": [{"raw": f"the {sname} below"}]})
    files = {"JSON": ("panoptic.json", {"categories": cats, "annotations": pan_anns}),
             "CAPTION_JSON": ("captions.json", {"annotations": cap_anns}),
             "GROUNDING_JSON": ("grounding.json", {"annotations": grd_anns})}
    spec = {"KIND": "coco_panoptic_caption_grounding", "IMAGE_DIR": img_dir,
            "PANOPTIC_DIR": pan_dir, "NUM_CLASSES": len(class_names),
            "CLASS_NAMES": list(class_names)}
    for key, (fname, obj) in files.items():
        spec[key] = os.path.join(root, fname)
        with open(spec[key], "w") as f:
            json.dump(obj, f)
    return spec


def write_clip_tokenizer(path, corpus, n_ids=CLIP_VOCAB, learn=2000):
    """A CLIP-layout ``vocab.json`` + ``merges.txt`` of exactly ``n_ids``
    ids, synthesized deterministically: the 256 byte characters, the same
    with ``</w>``, up to ``learn`` merges learned on ``corpus`` (the most
    frequent pair first, ties to the pair counted first, while a pair occurs
    twice), two-character merges in byte order up to ``n_ids - 2`` tokens,
    then <|startoftext|> and <|endoftext|> (49406 and 49407 at the full
    size).  Returns the number of learned merges."""
    from cullavo_tpu_torch.data.clip_tokenizer import (BOS, EOS, SUFFIX, bytes_to_unicode,
                                                       normalize, split_pieces)

    byte_char = bytes_to_unicode()
    chars = list(byte_char.values())
    vocab = chars + [c + SUFFIX for c in chars]
    have = set(vocab)
    counts = collections.Counter()
    for text in corpus:
        for piece in split_pieces(normalize(text)):
            syms = [byte_char[b] for b in piece.encode("utf-8")]
            syms[-1] += SUFFIX
            counts[tuple(syms)] += 1
    words, freqs = [list(w) for w in counts], list(counts.values())
    n_merges = n_ids - len(vocab) - 2
    merges = []
    while len(merges) < min(learn, n_merges):
        pairs = collections.Counter()
        for syms, f in zip(words, freqs):
            for pair in zip(syms, syms[1:]):
                pairs[pair] += f
        if not pairs or pairs.most_common(1)[0][1] < 2:
            break
        a, b = pairs.most_common(1)[0][0]
        merges.append((a, b))
        have.add(a + b)
        for syms in words:
            i = 0
            while i < len(syms) - 1:
                if syms[i] == a and syms[i + 1] == b:
                    syms[i:i + 2] = [a + b]
                i += 1
    learned = len(merges)
    for a in chars:
        for b in vocab[:2 * len(chars)]:
            if len(merges) < n_merges and a + b not in have:
                merges.append((a, b))
                have.add(a + b)
    vocab += [a + b for a, b in merges] + [BOS, EOS]
    if len(vocab) != n_ids or len(set(vocab)) != n_ids:
        raise RuntimeError(f"CLIP vocabulary of {len(vocab)} tokens, not {n_ids} distinct")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump({t: i for i, t in enumerate(vocab)}, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    return learned


def write_semseg_dataset(root, sizes, class_names, seed=0):
    """A ``semseg`` dataset under ``root``: per size a random image (a PNG
    named ``.jpg``, as the reference's images are named) and a grey
    annotation PNG of 32-pixel blocks of random class ids, 255 (ignore) in
    every seventh block.  Returns its ``DATASETS.REGISTER`` entry."""
    import numpy as np

    from cullavo_tpu_torch.data import png_io

    rng = np.random.default_rng(seed)
    img_dir, ann_dir = os.path.join(root, "images"), os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for k, (H, W) in enumerate(sizes):
        blocks = rng.integers(0, len(class_names), (-(-H // 32), -(-W // 32)))
        blocks.reshape(-1)[::7] = 255
        ann = np.kron(blocks, np.ones((32, 32), np.int64))[:H, :W].astype(np.uint8)
        png_io.write_png(os.path.join(img_dir, f"{k:012d}.jpg"),
                         rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        png_io.write_png(os.path.join(ann_dir, f"{k:012d}.png"), ann)
    return {"KIND": "semseg", "IMAGE_DIR": img_dir, "ANN_DIR": ann_dir,
            "NUM_CLASSES": len(class_names), "CLASS_NAMES": list(class_names)}


def write_refcoco_dataset(root, sizes, class_names, seed=0):
    """A ``refcoco`` dataset under ``root``: per size a random image (a PNG
    named ``.jpg``) with one referred object, a rectangle given as a
    polygon (the last image's as an uncompressed RLE), two sentences each
    (split "val"), and one reference of split "train" that the val loader
    skips.  Returns its ``DATASETS.REGISTER`` entry."""
    import numpy as np

    from cullavo_tpu_torch.data import png_io

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, anns, refs = [], [], []
    for k, (H, W) in enumerate(sizes):
        name = f"{k:012d}.jpg"
        png_io.write_png(os.path.join(img_dir, name),
                         rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        images.append({"id": k, "file_name": name, "height": H, "width": W})
        h, w = int(rng.integers(H // 4, H // 2)), int(rng.integers(W // 4, W // 2))
        y, x = int(rng.integers(0, H - h)), int(rng.integers(0, W - w))
        if k == len(sizes) - 1:
            m = np.zeros((H, W), bool)
            m[y:y + h, x:x + w] = True
            seg = {"counts": _rle_counts(m), "size": [H, W]}
        else:
            seg = [[x, y, x + w, y, x + w, y + h, x, y + h]]
        cat = int(rng.integers(0, len(class_names)))
        anns.append({"id": 100 + k, "image_id": k, "category_id": cat, "bbox": [x, y, w, h],
                     "segmentation": seg, "iscrowd": 0})
        c = class_names[cat]
        refs.append({"ann_id": 100 + k, "image_id": k, "split": "val", "category_id": cat,
                     "sentences": [{"sent": f"the {c} on the {('left', 'right')[k % 2]}"},
                                   {"sent": f"a {c} next to {k + 2} others, near the edge"}]})
    refs.append(dict(refs[0], split="train"))
    spec = {"KIND": "refcoco", "IMAGE_DIR": img_dir,
            "REFS_JSON": os.path.join(root, "refs.json"),
            "INSTANCES_JSON": os.path.join(root, "instances.json")}
    with open(spec["REFS_JSON"], "w") as f:
        json.dump(refs, f)
    with open(spec["INSTANCES_JSON"], "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": i, "name": n} for i, n in enumerate(class_names)]}, f)
    return spec


def xtrain_argv(over, save_dir=None, seed=None):
    """The command line of phase 15: ``train`` on configs/xdecoder_train.yaml
    with ``over`` as ``--config_overrides``, ``SAVE_DIR`` and ``SEED``
    where given."""
    pairs = (["SAVE_DIR", save_dir] if save_dir else []) + (
        ["SEED", str(seed)] if seed is not None else [])
    return ["train", "--conf_files", os.path.join(REPO, XTRAIN_CFG), "--config_overrides",
            json.dumps(over)] + (["--overrides", *pairs] if pairs else [])


def xtrain_config(over=None, save_dir="unused"):
    """configs/xdecoder_train.yaml as the port's own reader gives it."""
    from cullavo_tpu_torch.config import load_opt_command

    return load_opt_command(xtrain_argv(over or {}, save_dir))[0].to_dict()


def xtrain_entry_smoke(device, smi):
    """Phase 15a: ``entry.train`` on configs/xdecoder_train.yaml with
    ``DATASETS.TRAIN`` unset: the full model, its optimizer and step are
    built on the card and the entry returns None without a step, as JAX's."""
    from cullavo_tpu_torch import entry

    t0 = time.perf_counter()
    res = entry.train(xtrain_config(), device=device)
    if res is not None:
        raise RuntimeError(f"entry.train({XTRAIN_CFG}) without DATASETS.TRAIN: {res}")
    log(f"entry.train({XTRAIN_CFG}) without DATASETS.TRAIN on the card ({smi}): None in "
        f"{time.perf_counter() - t0:.1f} s")


def _grad_errors(got, want):
    """max |d| / max |ref| of each pair of gradients."""
    return [((g.float() - w.float()).abs().max() / w.float().abs().max()).item()
            for g, w in zip(got, want)]


def check_train_functions(device, rec, smi):
    """Phase 15b: K10 and K9 under autograd on the card.  K10's Function at
    FocalNet-L's stage-1 shape of the train step ([8, 192, 128 x 128], 4
    levels) and K9's at phase 9's deformable-encoder shape (value [8, 5376,
    8, 64], 3 levels x 4 points), f32 and bf16: the gradients of every
    input within 1e-3 of their largest entry of autograd through the plain
    version on the card (K9's bf16 value gradient: within twice the plain
    version's own run-to-run spread, its atomic bf16 sums), the output's
    grad_fn set, one launch each.  Times
    K10's forward and its backward (the plain version's autograd, JAX's
    custom-VJP form) in bf16, and K9's, into ``rec``."""
    import torch

    from cullavo_tpu_torch.ops import focal, msdeform

    B, C, H, W, kernels = 8, 192, 128, 128, (3, 5, 7, 9)
    g = torch.Generator(device=device).manual_seed(SEED)
    for dtype in (torch.float32, torch.bfloat16):
        fx = torch.randn((B, 2 * C + 5, H * W), generator=g, device=device).to(dtype)
        taps = torch.cat([torch.randn((C, k * k), generator=g, device=device) * (0.6 / k)
                          for k in kernels], dim=1)
        up = torch.randn((B, C, H * W), generator=g, device=device)
        approx = dtype == torch.bfloat16
        leaves = [[t.detach().clone().requires_grad_(True)
                   for t in (fx[:, C:2 * C], fx[:, 2 * C:], taps)] for _ in range(2)]
        n0 = focal.focal_ctx_kernel.launches
        out = focal.focal_ctx_kernel(*leaves[0], H, W, kernels, True, approx)
        if focal.focal_ctx_kernel.launches != n0 + 1 or out.grad_fn is None:
            raise RuntimeError("K10 under autograd: no launch or no grad_fn")
        ref = focal.focal_ctx_plain(*leaves[1], H, W, kernels, True, approx)
        got = torch.autograd.grad((out.float() * up).sum(), leaves[0])
        want = torch.autograd.grad((ref.float() * up).sum(), leaves[1])
        errs = _grad_errors(got, want)
        log(f"K10 Function [{B}, {C}, {H}x{W}] {dtype} ({smi}): d ctx, d gates, d taps vs "
            f"autograd through the plain version: {', '.join(f'{e:.2e}' for e in errs)} "
            f"(tol 1e-3)")
        if max(errs) > 1e-3:
            raise RuntimeError(f"K10 gradients disagree with the plain version's: {errs}")
        if dtype == torch.bfloat16:
            ins = [t.detach().requires_grad_(True) for t in leaves[0]]

            def fwd():
                return focal.focal_ctx_kernel(*ins, H, W, kernels, True, approx)

            o = fwd()
            bwd = bench_ms(lambda: torch.autograd.grad(o, ins, up.to(o.dtype),
                                                       retain_graph=True), device)
            fwd_ms = bench_ms(fwd, device)
            # the backward's least work: per level the input gradient and the
            # tap gradient, each a depthwise pass over the in-map taps, one
            # multiply-add each (f32); bytes: ctx, gates, taps and the output
            # gradient read once, their three gradients written once
            bbd = bound(2 * nbytes(*ins) + up.numel() * o.element_size(),
                        4 * focal_taps_in_map(H, W, kernels) * B * C, "f32")
            rec["focal_ctx"]["train_shape"] = [B, C, H * W]
            rec["focal_ctx"]["train_fwd_ms"] = fwd_ms
            rec["focal_ctx"]["plain_backward_ms"] = bwd
            rec["focal_ctx"]["plain_backward_bound"] = bbd
            log(f"K10 at the train step's stage 1 [{B}, {C}, {H}x{W}] bf16 ({smi}): forward "
                f"(K10) {fwd_ms:.4f} ms, backward (plain version's autograd) {bwd:.4f} ms, "
                f"backward bound {bbd['bound_ms']:.4f} ms ({bbd['bound_by']})")
    shapes = ((64, 64), (32, 32), (16, 16))
    S = sum(h * w for h, w in shapes)
    for dtype in (torch.float32, torch.bfloat16):
        value = torch.randn((8, S, 8, 64), generator=g, device=device).to(dtype)
        loc = torch.rand((8, S, 8, 3, 4, 2), generator=g, device=device) * 1.2 - 0.1
        att = torch.softmax(torch.randn((8, S, 8, 12), generator=g, device=device),
                            -1).reshape(8, S, 8, 3, 4)
        up = torch.randn((8, S, 8 * 64), generator=g, device=device)
        leaves = [[t.detach().clone().requires_grad_(True) for t in (value, loc, att)]
                  for _ in range(3)]
        n0 = msdeform.ms_deform_attn_kernel.launches
        out = msdeform.ms_deform_attn_kernel(leaves[0][0], shapes, leaves[0][1], leaves[0][2])
        if msdeform.ms_deform_attn_kernel.launches != n0 + 1 or out.grad_fn is None:
            raise RuntimeError("K9 under autograd: no launch or no grad_fn")
        got = torch.autograd.grad((out.float() * up).sum(), leaves[0])
        want, again = (torch.autograd.grad((msdeform.ms_deform_attn(
            ls[0], shapes, ls[1], ls[2]).float() * up).sum(), ls) for ls in leaves[1:])
        errs, spread = _grad_errors(got, want), _grad_errors(again, want)
        log(f"K9 Function [8, {S}, 8, 64] {dtype} ({smi}): d value, d loc, d weights vs "
            f"autograd through the plain version: {', '.join(f'{e:.2e}' for e in errs)} (tol "
            f"1e-3; the plain version against itself: "
            f"{', '.join(f'{e:.2e}' for e in spread)})")
        # d value sums by atomic adds in value's dtype: in bf16 their order
        # moves it from run to run, the plain version's own too; it may stray
        # by twice the plain version's own spread
        if max(errs[1:]) > 1e-3 or errs[0] > max(1e-3, 2 * spread[0]):
            raise RuntimeError(f"K9 gradients disagree with the plain version's: {errs}")
        if dtype == torch.bfloat16:
            ins = [t.detach().requires_grad_(True) for t in leaves[0]]
            o = msdeform.ms_deform_attn_kernel(ins[0], shapes, ins[1], ins[2])
            rec["ms_deform_attn"]["plain_backward_ms"] = bench_ms(
                lambda: torch.autograd.grad(o, ins, up.to(o.dtype), retain_graph=True), device)
            # the backward's least work per sampling point and channel (f32
            # multiply-adds): the 4-corner sample again (4), its scatter into
            # d value (4), d weight (1), d loc in x and y (2 x 4); bytes: value,
            # loc, weights and the output gradient read once, their three
            # gradients written once
            points = 8 * S * 8 * len(shapes) * 4
            bbd = bound(2 * nbytes(*ins) + up.numel() * o.element_size(),
                        2 * 17 * 64 * points, "f32")
            rec["ms_deform_attn"]["plain_backward_bound"] = bbd
            log(f"K9's backward (plain version's autograd) at that shape, bf16 ({smi}): "
                f"{rec['ms_deform_attn']['plain_backward_ms']:.4f} ms, bound "
                f"{bbd['bound_ms']:.4f} ms ({bbd['bound_by']})")


def pinned_points(seed):
    """Replace the criterion's and matcher's random points (uniform draws and
    the importance sampler) by one seeded numpy sequence in call order, so
    the card and the CPU sample the same points.  Returns the restore
    function."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.models.xdecoder import criterion, matcher

    rng = np.random.default_rng(seed)

    def uniform(shape, generator, device):
        return torch.from_numpy(rng.random(tuple(shape), dtype=np.float32)).to(device)

    saved = (matcher.uniform_points, criterion.uniform_points, criterion.uncertain_point_coords)
    matcher.uniform_points = criterion.uniform_points = uniform
    criterion.uncertain_point_coords = lambda m, gen, n, *a, **k: uniform((m.shape[0], n, 2),
                                                                           gen, m.device)

    def restore():
        matcher.uniform_points, criterion.uniform_points, criterion.uncertain_point_coords = saved
    return restore


def xtrain_batch(spec, model_cfg, n, seed=SEED):
    """The first ``n`` records of the registered spec mapped at the config's
    512^2 and collated as the entry collates them (plus class tokens and
    the normalized image)."""
    import numpy as np

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.data.coco_caption_grounding import (
        JointTrainMapper, collate_joint, load_coco_panoptic_caption_grounding_json)
    from cullavo_tpu_torch.data.mappers.eval_mappers import normalize_np

    names = spec["CLASS_NAMES"]
    recs = load_coco_panoptic_caption_grounding_json(
        spec["JSON"], spec["IMAGE_DIR"], spec["PANOPTIC_DIR"], spec["CAPTION_JSON"],
        spec["GROUNDING_JSON"], {})[:n]
    mapper = JointTrainMapper(image_size=XDEC_SIDE, class_names=names)
    mapped = [mapper(r) for r in recs]
    tokenize = entry._make_text_tokenize({}, model_cfg.text)
    batch = collate_joint(mapped, tokenize, names, np.random.default_rng(seed))
    batch["image"] = np.stack([normalize_np(m["image"]) for m in mapped])
    batch["class_ids"], batch["class_mask"] = tokenize(
        [f"a photo of a {c}." for c in names] + ["A background in coco."])
    return batch


def reference_check_xtrain(spec, device, wrappers, smi):
    """Phase 15c: the joint objective at full width and cut depth (one block
    per FocalNet stage, one FPN encoder layer, 2 decoder and 2 text layers),
    f32, on 2 images of 512^2, points pinned: every loss and every gradient
    leaf of the kernel path on the card (remat on) against the plain path on
    the CPU (remat off), same weights drawn on the CPU.  Losses within 1e-3
    of the largest; each gradient leaf within 1e-3 in its 2-norm (|d| /
    |ref|) and within 1e-2 of its largest entry (a leaf whose gradient is
    zero in exact arithmetic holds rounding noise: 1e-6 of the largest entry
    of all is the floor).  Not 1e-3 entry by entry: the FPN's ReLU and
    GroupNorm kinks flip on f32 rounding, and one flip moves single entries
    of a leaf by ~2e-3 of its largest even between two CPU runs whose
    images differ by one ulp (measured on this check's inputs:
    output_convs/1/kernel 2.0e-3, its 2-norm 3.7e-4)."""
    import torch

    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
    from cullavo_tpu_torch.models.xdecoder.model import (forward_joint_train,
                                                         init_xdecoder_model_params)
    from cullavo_tpu_torch.trainer.xdecoder_step import _value_and_grad

    full = xdecoder_model_config_from(xtrain_config())
    cfg = dataclasses.replace(full, backbone=dataclasses.replace(full.backbone,
                                                                 depths=(1, 1, 1, 1)),
                              fpn=dataclasses.replace(full.fpn, enc_layers=1),
                              decoder=dataclasses.replace(full.decoder, dec_layers=2),
                              text=dataclasses.replace(full.text, layers=2))
    batch = xtrain_batch(spec, cfg, XTRAIN_CUT_IMAGES)
    params = init_xdecoder_model_params(cfg, torch.Generator().manual_seed(SEED), "cpu")
    runs = []
    for dev, remat in ((torch.device("cpu"), False), (device, True)):
        restore = pinned_points(SEED)
        t0 = time.perf_counter()

        def loss_fn(p, b, gen, remat=remat):
            losses = forward_joint_train(p, cfg, b, gen, remat=remat)
            return sum(losses.values()), losses

        (total, losses, grads), counts = counted(wrappers, lambda: _value_and_grad(
            loss_fn, _tree_to(params, device=dev), batch, None))
        restore()
        runs.append((losses, {k: g.float().cpu() for k, g in _tree_leaves(grads)}, counts))
        log(f"X-Decoder train cut ({XTRAIN_CUT_IMAGES} x {XDEC_SIDE}^2, f32) on {dev} "
            f"({smi}): {len(losses)} losses, total {float(total):.6f}, "
            f"{time.perf_counter() - t0:.1f} s")
    (want_l, want_g, _), (got_l, got_g, counts) = runs
    big = max(abs(float(v)) for v in want_l.values())
    loss_err = max(abs(float(got_l[k]) - float(want_l[k])) for k in want_l) / big
    floor = 1e-6 * max(float(w.abs().max()) for w in want_g.values())
    rows = sorted(((float((got_g[k] - w).norm()) / max(float(w.norm()), floor),
                    float((got_g[k] - w).abs().max()) / max(float(w.abs().max()), floor), k)
                   for k, w in want_g.items()), reverse=True)
    worst_max = max(rows, key=lambda r: r[1])
    log(f"X-Decoder train cut ({smi}): card vs CPU, losses max |d| / max |loss| = "
        f"{loss_err:.3e} (tol "
        f"1e-3); gradients ({len(want_g)} leaves) per leaf |d| / |ref| (2-norms) up to "
        f"{rows[0][0]:.3e} (tol 1e-3), max |d| / max |ref| up to {worst_max[1]:.3e} (tol "
        f"1e-2) at {worst_max[2]}; K10 launches {counts['focal_ctx']}; worst leaves "
        + ", ".join(f"{k} {n:.2e} / {m:.2e}" for n, m, k in rows[:3]))
    if set(got_l) != set(want_l) or loss_err > 1e-3 or rows[0][0] > 1e-3 or \
            worst_max[1] > 1e-2 or counts["focal_ctx"] != 2 * 4:
        raise RuntimeError(f"X-Decoder train cut: the card disagrees with the CPU (losses "
                           f"{loss_err}, gradients {rows[:3]}, {worst_max}) or K10 launched "
                           f"{counts['focal_ctx']} times, not 8")


def _check_losses(label, metrics):
    import math

    missing = [k for k in XTRAIN_LOSS_KEYS if k not in metrics]
    bad = [k for k in XTRAIN_LOSS_KEYS + ("loss_total", "grad_norm")
           if k in metrics and not math.isfinite(float(metrics[k]))]
    if missing or bad or not float(metrics["grad_norm"]) > 0:
        raise RuntimeError(f"{label}: loss keys missing {missing}, not finite {bad}, "
                           f"grad_norm {metrics.get('grad_norm')}")


def _train_steps(cfg, sol, batch, device, steps, base_lr, warmup, timed=False):
    """``steps`` joint steps on one batch from a fresh model (seed 0) and
    generator (seed SEED), bf16 over f32 masters with remat, as the entry
    builds them: (metrics of every step, per-step seconds, matcher host
    seconds, forward seconds)."""
    import torch

    from cullavo_tpu_torch.entry import _load_xdecoder_params
    from cullavo_tpu_torch.models.xdecoder import matcher
    from cullavo_tpu_torch.trainer import xdecoder_step
    from cullavo_tpu_torch.trainer.optimizer import xdecoder_optimizer
    from cullavo_tpu_torch.trainer.step import TrainState

    params = _load_xdecoder_params({}, cfg, device)
    tx = xdecoder_optimizer(base_lr=base_lr, total_steps=int(sol["MAX_ITER"]),
                            grad_clip=float(sol["CLIP_VALUE"]), warmup_steps=warmup)
    state = TrainState(params, tx.init(params), 0)
    step = xdecoder_step.make_xdecoder_joint_train_step(cfg, tx, remat=True,
                                                       compute_dtype=torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(SEED)
    fwd = xdecoder_step.forward_joint_train
    fwd_s = []

    def timed_forward(*a, **k):
        torch.cuda.synchronize(device)
        t = time.perf_counter()
        out = fwd(*a, **k)
        torch.cuda.synchronize(device)
        fwd_s.append(time.perf_counter() - t)
        return out

    if timed:
        xdecoder_step.forward_joint_train = timed_forward
    history, secs, host = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize(device)
        h0, t0 = matcher.hungarian_match.host_seconds, time.perf_counter()
        state, metrics = step(state, batch, gen)
        history.append({k: float(v) for k, v in metrics.items()})
        secs.append(time.perf_counter() - t0)
        host.append(matcher.hungarian_match.host_seconds - h0)
    xdecoder_step.forward_joint_train = fwd
    return history, secs, host, fwd_s


def run_xtrain_path(device, wrappers, smi, work, rec):
    """Phase 15: X-Decoder joint training.  (a) and (b) as their functions
    say; then a registered coco_panoptic_caption_grounding dataset of 16
    synthetic images (12 of 512^2, 4 of 480 x 640; PNGs and id-encoded
    panoptic PNGs by the port's writer, thing and stuff segments and a
    crowd one, 5 captions an image, polygon and RLE grounding segments; the
    133 COCO panoptic names); (c) the cut-depth card-vs-CPU check on its
    first 2 images; (d) the main path: ``entry.train`` on ``python -m
    cullavo_tpu_torch train --conf_files configs/xdecoder_train.yaml``'s
    arguments in this process (the command line itself runs in phase 22b,
    on two ranks), launches counted
    (K10: 48 a step), every reference loss key present and finite in both
    steps, grad_norm finite and > 0, the checkpoint read back bit-equal;
    (e) 4 steps on the first batch, then 1 step again from one seed:
    step-1 losses within 1e-3 relative, s per step (median
    of steps 2-4), images/s, the
    matcher's host seconds and the forward's seconds a step, K10's plain
    backward a step; (f) 6 steps at BASE_LR 1e-3 without warmup: the loss
    at step 6 below step 1.  Returns the launch counts of (d) and phase
    22b's reference (the dataset's registration, (d)'s steps' metrics)."""
    import statistics as st

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.checkpoint.store import load_checkpoint
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
    from cullavo_tpu_torch.ops import focal
    from cullavo_tpu_torch.utils.constants import COCO_PANOPTIC_CLASSES
    from cullavo_tpu_torch.utils.tree import tree_leaves

    xtrain_entry_smoke(device, smi)
    check_train_functions(device, rec, smi)
    root = os.path.join(work, "xtrain_data")
    t0 = time.perf_counter()
    spec = write_joint_dataset(root, XDEC_SIZES, list(COCO_PANOPTIC_CLASSES), len(XDEC_THINGS),
                               seed=SEED)
    log(f"phase 15 dataset ({smi}): {len(XDEC_SIZES)} images written in "
        f"{time.perf_counter() - t0:.1f} s")
    reference_check_xtrain(spec, device, wrappers, smi)

    over = {"DATASETS.TRAIN": [XTRAIN_DATASET],
            "DATASETS.REGISTER": {XTRAIN_DATASET: spec}}
    in_dir = os.path.join(work, "xtrain_in_process")
    cfg = xtrain_config(over, in_dir)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out, counts = counted(wrappers, lambda: entry.train(cfg, device=device))
    torch.cuda.synchronize(device)
    t_in = time.perf_counter() - t0
    peak_in = torch.cuda.max_memory_allocated(device) / 2 ** 30
    history = out["history"]
    for i, m in enumerate(history):
        _check_losses(f"entry.train step {i + 1}", m)
    saved = tree_leaves(load_checkpoint(in_dir)["params"])
    final = [t.cpu().numpy() for t in tree_leaves(out["state"].trainable)]
    if len(history) != 2 or len(saved) != len(final) or not all(
            a.dtype == b.dtype and (a == b).all() for a, b in zip(saved, final)):
        raise RuntimeError("entry.train: not 2 steps, or the checkpoint does not read back "
                           "bit-equal")
    ref = {"spec": spec, "history": history, "launches": counts}
    log(f"xdecoder train entry.train in process ({smi}): 2 steps in {t_in:.2f} s, losses "
        f"{[round(m['loss_total'], 4) for m in history]}, grad_norm "
        f"{[round(m['grad_norm'], 6) for m in history]}, {len(XTRAIN_LOSS_KEYS)} reference "
        f"loss keys finite; peak {peak_in:.2f} GiB; checkpoint bit-equal; launches {counts}")
    if counts["focal_ctx"] != 2 * XTRAIN_FOCAL_PER_STEP:
        raise RuntimeError(f"K10 launched {counts['focal_ctx']} times in 2 steps, not "
                           f"{2 * XTRAIN_FOCAL_PER_STEP} (24 blocks + their remat)")
    del out
    torch.cuda.empty_cache()

    model_cfg = xdecoder_model_config_from(cfg)
    batch = xtrain_batch(spec, model_cfg, XDEC_BATCH)
    sol = cfg["SOLVER"]
    events = []
    orig = focal._FocalCtx.backward

    def timed_backward(fctx, grad):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        result = orig(fctx, grad)
        b.record()
        events.append((a, b))
        return result

    focal._FocalCtx.backward = staticmethod(timed_backward)
    first = _train_steps(model_cfg, sol, batch, device, XTRAIN_DET_STEPS, float(sol["BASE_LR"]),
                         10, timed=True)
    focal._FocalCtx.backward = staticmethod(orig)
    torch.cuda.synchronize(device)
    k10_bwd_ms = sum(a.elapsed_time(b) for a, b in events) / XTRAIN_DET_STEPS
    second = _train_steps(model_cfg, sol, batch, device, 1, float(sol["BASE_LR"]), 10)
    a, b = first[0][0], second[0][0]
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6) for k in XTRAIN_LOSS_KEYS)
    hist, secs, host, fwd = first
    s_step = st.median(secs[1:])
    log(f"xdecoder train determinism ({smi}): step-1 losses of two runs from one seed agree "
        f"within {worst:.2e} relative (tol 1e-3); losses "
        f"{[round(m['loss_total'], 4) for m in hist]}")
    if worst > 1e-3:
        raise RuntimeError(f"xdecoder train: two runs from one seed differ at step 1 ({worst})")
    log(f"xdecoder train at full width and depth ({smi}): {s_step:.4f} s per step (median of "
        f"steps 2-{XTRAIN_DET_STEPS}; steps {[round(x, 4) for x in secs]}), "
        f"{XDEC_BATCH / s_step:.2f} images/s, forward {st.median(fwd[1:]):.4f} s a step, "
        f"matcher host {st.median(host[1:]):.4f} s a step, K10's plain backward "
        f"{k10_bwd_ms:.2f} ms a step")
    rec["focal_ctx"]["xdecoder_train"] = {
        "s_per_step": s_step, "images_per_s": XDEC_BATCH / s_step,
        "forward_s": st.median(fwd[1:]), "matcher_host_s": st.median(host[1:]),
        "k10_plain_backward_ms_per_step": k10_bwd_ms, "peak_gib_in_process": peak_in}
    learn = _train_steps(model_cfg, sol, batch, device, XTRAIN_LEARN_STEPS, XTRAIN_LEARN_LR, 0)[0]
    losses = [m["loss_total"] for m in learn]
    log(f"xdecoder train learning (BASE_LR {XTRAIN_LEARN_LR}, no warmup; {smi}): losses "
        f"{[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"xdecoder train: the loss at step {len(losses)} is not below step 1")
    torch.cuda.empty_cache()
    return counts, ref


XEVAL_SEMSEG, XEVAL_PANOPTIC, XEVAL_REFCOCO = (
    "ade20k_val_sem_seg_synthetic", "coco_2017_val_panoptic_with_sem_seg", "refcocog_val_umd")
XEVAL_REF_IMAGES = 8          # 16 sentences, two a referred object
XEVAL_TOKENIZER_TEXTS = 1000


def xeval_argv(over, *pairs, path_cfg=None):
    """The command line of phases 16 and 17: ``eval`` on ``path_cfg``
    (configs/xdecoder_test.yaml by default)."""
    return ["eval", "--conf_files", os.path.join(REPO, path_cfg or XDEC_FOCAL),
            "--config_overrides", json.dumps(over), "--overrides", *pairs]


def _noisy_params(cfg, device, seed):
    """The port's random initial weights with N(0, 0.01) added to every
    leaf (zero biases and unit norms take part in the round trip)."""
    import torch

    from cullavo_tpu_torch.models.xdecoder.model import init_xdecoder_model_params
    from cullavo_tpu_torch.utils.tree import tree_map

    gen = torch.Generator(device=device).manual_seed(seed)
    params = init_xdecoder_model_params(cfg, gen, device)
    return tree_map(lambda t: t + 0.01 * torch.randn(t.shape, generator=gen, device=device),
                    params)


def checkpoint_round_trip(path_cfg, device, work, smi, cfg_dict=None):
    """Phase 16a for one configuration (``path_cfg``'s dict, or
    ``cfg_dict``): random weights at full width and depth written in the
    reference's key names as a ``.pt`` (the inverse table), read back
    through ``RESUME_FROM``: every leaf bit-equal.  Returns the file and the
    load seconds."""
    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.checkpoint.xdecoder_import import reference_state_from_params
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
    from cullavo_tpu_torch.utils.tree import tree_leaves

    cfg = xdecoder_model_config_from(cfg_dict or XDEC_CONFIGS[path_cfg])
    params = _noisy_params(cfg, device, SEED + 16)
    state = reference_state_from_params(params, cfg)
    path = os.path.join(work, os.path.basename(path_cfg).replace(".yaml", ".pt"))
    t0 = time.perf_counter()
    torch.save({"model": state}, path)
    t_write = time.perf_counter() - t0
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    back = entry._load_xdecoder_params({"RESUME_FROM": path}, cfg, device)
    torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0
    a, b = tree_leaves(params), tree_leaves(back)
    if len(a) != len(b) or not all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError(f"{path_cfg}: the checkpoint does not read back bit-equal")
    n = sum(t.numel() for t in a)
    log(f"checkpoint {path_cfg} ({smi}): {len(state)} reference keys, {n / 1e6:.1f} M "
        f"f32 parameters, {os.path.getsize(path) / 2**30:.2f} GiB .pt written in {t_write:.2f} s, "
        f"read through RESUME_FROM in {t_load:.2f} s; {len(b)} leaves bit-equal")
    del params, back, state
    torch.cuda.empty_cache()
    return path, t_load


def _xeval_forwards(spec_sizes, batch):
    """Forward passes of the eval over datasets whose rows have these image
    sizes (a batch per bucket chunk; refcoco rows share one text bucket)."""
    from cullavo_tpu_torch.pipelines.xdecoder_pipeline import _bucket_hw

    total = 0
    for sizes in spec_sizes:
        buckets = collections.Counter(_bucket_hw(h, w) for h, w in sizes)
        total += sum(-(-n // batch) for n in buckets.values())
    return total


def _check_xeval(res, label):
    """mIoU, PQ, grounding cIoU / mIoU present, finite and in [0, 100]."""
    vals = {"mIoU": res[XEVAL_SEMSEG]["sem_seg"]["mIoU"],
            "panoptic mIoU": res[XEVAL_PANOPTIC]["sem_seg"]["mIoU"],
            "PQ": res[XEVAL_PANOPTIC]["panoptic"]["PQ"],
            "grounding cIoU": res[XEVAL_REFCOCO]["cIoU"],
            "grounding mIoU": res[XEVAL_REFCOCO]["mIoU"]}
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in vals.values()):
        raise RuntimeError(f"{label}: metrics out of range: {vals}")
    return vals


def _strip_timing(res):
    return {name: {k: v for k, v in r.items() if k != "timing"} for name, r in res.items()}


def run_xeval_path(device, wrappers, smi, work, rec):
    """Phase 16: the X-Decoder eval from a checkpoint (run in phase 15's
    working directory).  (a) FocalNet-L + FPN and SAM-ViT-B + the
    deformable encoder: ``checkpoint_round_trip``; the FocalNet-L file under
    FocalNet-T widths raises.  (b) a CLIP ``vocab.json`` + ``merges.txt`` of
    49408 ids (``write_clip_tokenizer``), its read and tokenize seconds per
    1000 texts.  (c) a ``semseg`` dataset (phase 9's 16 sizes, the 150
    ADE20K names), phase 12's ``coco_panoptic`` writer (16 of 480 x 640, the
    133 COCO panoptic classes) and a ``refcoco`` dataset (16 sentences on 8
    images of 512^2, polygons and one RLE), PNGs by the port's writer.
    (d) ``evaluate_grounding`` at full width and cut depth, f32, one 256 x
    320 image: card against CPU within 1e-3 of the largest mask logit.
    (e) ``python -m cullavo_tpu_torch eval --conf_files
    configs/xdecoder_test.yaml`` in a subprocess (f32) with ``RESUME_FROM``
    the .pt, ``MODEL.TEXT.TOKENIZER`` and the three datasets: exit 0,
    metrics in range; then ``entry.evaluate`` on the same arguments in this
    process in bf16, twice: equal metrics, K10 24 a forward (the main path:
    the first run's counts are returned), images/s, compute s per batch and
    peak memory by dataset; then the grounding dataset from phase 15's
    checkpoint directory (train -> eval).  Returns the first run's counts
    and the FocalNet-L ``.pt``, which phase 17 reads."""
    import numpy as np
    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.config import load_opt_command
    from cullavo_tpu_torch.data.clip_tokenizer import CLIPTokenizer
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
    from cullavo_tpu_torch.models.xdecoder.model import evaluate_grounding, init_xdecoder_model_params
    from cullavo_tpu_torch.utils.constants import (ADE_PANOPTIC_CLASSES, COCO_PANOPTIC_CLASSES,
                                                   get_prompt_templates)

    t_phase = time.perf_counter()
    # (a)
    pt_focal, t_load = checkpoint_round_trip(XDEC_FOCAL, device, work, smi)
    pt_deform, _ = checkpoint_round_trip(XDEC_DEFORM, device, work, smi)
    os.remove(pt_deform)
    focal_t = json.loads(json.dumps(XDEC_CONFIGS[XDEC_FOCAL]))
    focal_t["MODEL"]["BACKBONE"]["FOCAL"] = {"EMBED_DIM": 96, "DEPTHS": [2, 2, 6, 2],
                                             "FOCAL_LEVELS": [3, 3, 3, 3],
                                             "FOCAL_WINDOWS": [3, 3, 3, 3]}
    loaded = False
    with contextlib.suppress(ValueError):
        entry._load_xdecoder_params({"RESUME_FROM": pt_focal},
                                    xdecoder_model_config_from(focal_t), device)
        loaded = True
    if loaded:
        raise RuntimeError("a FocalNet-L checkpoint loaded under FocalNet-T widths")
    log("phase 16: the FocalNet-L checkpoint under FocalNet-T widths raises ValueError (shape)")
    torch.cuda.empty_cache()

    # (b)
    templates = get_prompt_templates()
    texts = [t.format(c) for c in COCO_PANOPTIC_CLASSES for t in templates]
    tok_dir = os.path.join(work, "clip_tokenizer")
    t0 = time.perf_counter()
    learned = write_clip_tokenizer(tok_dir, texts[::7] + list(ADE_PANOPTIC_CLASSES))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    tk = CLIPTokenizer.from_dir(tok_dir)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids, mask = tk(texts[:XEVAL_TOKENIZER_TEXTS], 77)
    t_tok = time.perf_counter() - t0
    if ids.shape != (XEVAL_TOKENIZER_TEXTS, 77) or ids[0, 0] != 49406 or ids.max() > 49407:
        raise RuntimeError(f"CLIP tokenizer: ids {ids.shape}, first {ids[0, :4]}")
    log(f"phase 16 CLIP tokenizer ({smi}): {len(tk.vocab)} ids ({learned} merges learned on the "
        f"corpus) written in {t_write:.2f} s, read in {t_read:.2f} s, "
        f"{t_tok:.3f} s per {XEVAL_TOKENIZER_TEXTS} texts (cold word cache)")

    # (c)
    root = os.path.join(work, "xeval_data")
    ref_sizes = XDEC_SIZES[:XEVAL_REF_IMAGES]
    sem = write_semseg_dataset(os.path.join(root, "semseg"), XDEC_SIZES,
                               list(ADE_PANOPTIC_CLASSES), seed=SEED + 16)
    json_file, img_dir, pan_dir = write_panoptic_dataset(os.path.join(root, "coco"))
    pan = {"KIND": "coco_panoptic", "JSON": json_file, "IMAGE_DIR": img_dir,
           "PANOPTIC_DIR": pan_dir}
    ref = write_refcoco_dataset(os.path.join(root, "refcoco"), ref_sizes,
                                list(COCO_PANOPTIC_CLASSES), seed=SEED + 16)
    register = {XEVAL_SEMSEG: sem, XEVAL_PANOPTIC: pan, XEVAL_REFCOCO: ref}

    # (d)
    cut = xdecoder_cut(XDEC_FOCAL)
    params = init_xdecoder_model_params(cut, torch.Generator().manual_seed(SEED), "cpu")
    h, w = XDEC_CHECK_HW
    image = torch.from_numpy(np.random.default_rng(SEED).normal(size=(1, h, w, 3)).astype(
        np.float32))
    sids, smask = tk(["the dog on the left, next to a red car"], cut.text.context_length)
    outs = []
    for dev in (torch.device("cpu"), device):
        p = _tree_to(params, device=dev)
        got, counts = counted(wrappers, lambda: evaluate_grounding(
            p, cut, image.to(dev), sids, smask, out_size=(h, w)))
        outs.append(got.float().cpu())
    rel = ((outs[1] - outs[0]).abs().max() / outs[0].abs().max()).item()
    log(f"phase 16 evaluate_grounding cut ({h}x{w}, f32): card vs CPU max |d| / max |ref| = "
        f"{rel:.3e} (tol 1e-3); launches {counts}")
    if not (rel <= 1e-3 and counts["focal_ctx"] == sum(cut.backbone.depths)):
        raise RuntimeError(f"evaluate_grounding: the card disagrees with the CPU ({rel}) or K10 "
                           f"launched {counts['focal_ctx']} times")
    del params, p

    # (e) the command line, f32
    over = {"DATASETS.TEST": list(register), "DATASETS.REGISTER": register,
            "MODEL.TEXT.TOKENIZER": tok_dir}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "cullavo_tpu_torch"]
                         + xeval_argv(over, "RESUME_FROM", pt_focal, "SAVE_DIR",
                                      os.path.join(work, "xeval_cli")),
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    for line in (res.stderr.strip().splitlines()[-4:]):
        log(f"  xdecoder eval CLI: {line}")
    if res.returncode != 0:
        raise RuntimeError(f"xdecoder eval: python -m cullavo_tpu_torch exited {res.returncode}")
    cli = json.loads(res.stdout.strip().splitlines()[-1])
    vals = _check_xeval(cli, "xdecoder eval CLI")
    log(f"xdecoder eval CLI ({smi}): exit 0 in {t_cli:.2f} s (process start, checkpoint, class "
        f"embeddings, 3 datasets, f32); {vals}")

    # (e) in this process, bf16, twice
    cfg = load_opt_command(xeval_argv(over, "RESUME_FROM", pt_focal, "DTYPE", "bfloat16"))[0]
    cfg = cfg.to_dict()
    runs = []
    for i in range(2):
        if i:
            cfg["DATASETS"].pop("REGISTER")     # registered by the first run
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out, counts = counted(wrappers, lambda: entry.evaluate(cfg, device=device))
        torch.cuda.synchronize(device)
        runs.append((out, counts, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated(device) / 2**30))
    (res1, counts, wall, peak), (res2, _, wall2, _) = runs
    _check_xeval(res1, "entry.evaluate")
    # the refcoco rows: two sentences an image
    forwards = _xeval_forwards([XDEC_SIZES, [LOOP_IMAGE_HW] * LOOP_IMAGES,
                                [hw for hw in ref_sizes for _ in range(2)]], XDEC_BATCH)
    blocks = sum(xdecoder_model_config_from(XDEC_CONFIGS[XDEC_FOCAL]).backbone.depths)
    log(f"xdecoder eval in process ({smi}): {forwards} forwards, launches {counts}")
    if counts["focal_ctx"] != blocks * forwards or counts["ms_deform_attn"]:
        raise RuntimeError(f"K10 launched {counts['focal_ctx']} times, not {blocks} x {forwards}")
    if _strip_timing(res1) != _strip_timing(res2):
        raise RuntimeError(f"two evals gave different metrics: {res1} {res2}")
    timing = {name: r["timing"] for name, r in res1.items()}
    for name, t in timing.items():
        log(f"xdecoder eval {name} ({smi}, bf16, batch {t['eval_batch']}): "
            f"{t.get('images_per_s', 0.0):.3f} images/s after the first batch, compute "
            f"{t['compute_s']:.4f} s per batch (data {t['data_s']:.4f}, eval {t['eval_s']:.4f})")
    log(f"xdecoder eval in process ({smi}): run 1 {wall:.2f} s, run 2 {wall2:.2f} s (checkpoint "
        f"load, class embeddings, 3 datasets), metrics equal; peak memory {peak:.2f} GiB; "
        f"{_check_xeval(res1, 'entry.evaluate')}")
    # train -> eval: phase 15's store directory through RESUME_FROM
    t0 = time.perf_counter()
    trained = entry.evaluate({**cfg, "RESUME_FROM": os.path.join(work, "xtrain_in_process"),
                              "DTYPE": "float32", "DATASETS": {"TEST": [XEVAL_REFCOCO]}},
                             device=device)[XEVAL_REFCOCO]
    if not all(math.isfinite(trained[k]) for k in ("cIoU", "mIoU")):
        raise RuntimeError(f"eval from phase 15's checkpoint: {trained}")
    log(f"xdecoder eval from phase 15's trained checkpoint ({smi}): {XEVAL_REFCOCO} cIoU "
        f"{trained['cIoU']:.4f}, mIoU {trained['mIoU']:.4f} in {time.perf_counter() - t0:.2f} s")
    rec["focal_ctx"]["xdecoder_eval"] = {
        "checkpoint_load_s": t_load, "tokenizer_s_per_1000_texts":
            t_tok * 1000 / XEVAL_TOKENIZER_TEXTS, "forwards": forwards,
        "timing": timing, "peak_gib": peak, "cli_s": t_cli, "card": smi}
    log(f"phase 16 in {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return counts, pt_focal


VLP_DATASETS = ("vlp_val", "vlp_captioning_val")
# the karpathy test arrow: phase 9's 16 sizes three times over in two record
# batches, so the in-process evals time 5 batches of 8 after the first; the
# command line reads the first 16 (LIMIT)
VLP_SIZES, VLP_BATCH_ROWS, VLP_CLI_ROWS = XDEC_SIZES * 3, 24, 16
VLP_WORDS = ("a man woman dog cat person rides sits stands on in the red blue white car horse "
             "bus park street two three with table plate of food near water boat field grass "
             "holding next to large small").split()
DAVIT_CFG = "configs/xdecoder/davitd3_unicl_lang.yaml"


def write_vlp_dataset(root, sizes, seed=0, batch_rows=8):
    """``<root>/vlp/pretrain_arrows_code224/coco_caption_karpathy_test.arrow``
    by the port's writer: per size a random image as PNG bytes, 5 captions
    (6 for every fifth image, 7 for every seventh), string ids
    ``COCO_val2014_%012d.jpg``, record batches of ``batch_rows``.  Returns
    the file and its columns as written."""
    import numpy as np

    from cullavo_tpu_torch.data import arrow_ipc, png_io

    rng = np.random.default_rng(seed)
    n = len(sizes)
    columns = {
        "image": ("binary", [png_io.encode_png(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
                             for h, w in sizes]),
        "caption": ("list<utf8>", [[" ".join(rng.choice(VLP_WORDS, int(rng.integers(6, 12))))
                                    for _ in range(5 + (i % 5 == 0) + 2 * (i % 7 == 3))]
                                   for i in range(n)]),
        "image_id": ("utf8", [f"COCO_val2014_{9 + 37 * i:012d}.jpg" for i in range(n)])}
    path = os.path.join(root, "vlp", "pretrain_arrows_code224",
                        "coco_caption_karpathy_test.arrow")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrow_ipc.write_arrow(path, columns, batch_rows=batch_rows)
    return path, columns


def _check_vlp(res, label, n):
    """Recall in [0, 100]; CIDEr, BLEU, ROUGE-L and METEOR_approx finite;
    ``n`` images captioned."""
    ret, cap = res["vlp_val"], res["vlp_captioning_val"]
    vals = {k: ret[k] for k in ("ir@1", "ir@5", "ir@10", "tr@1", "tr@5", "tr@10")}
    scores = {k: cap[k] for k in ("CIDEr", "Bleu_1", "Bleu_4", "ROUGE_L", "METEOR_approx")}
    if not (all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in vals.values())
            and all(math.isfinite(v) for v in scores.values())
            and cap["n"] == n):
        raise RuntimeError(f"{label}: VLP metrics out of range: {vals} {scores} n={cap['n']}")
    return {**vals, **scores}


def _read_captions(out_dir, n):
    with open(os.path.join(out_dir, "vlp_captioning_val_captions.json")) as f:
        rows = json.load(f)
    if len(rows) != n:
        raise RuntimeError(f"{out_dir}: {len(rows)} captions, not {n}")
    return rows


def _datasets_root(root):
    """``DETECTRON2_DATASETS`` set to ``root`` for an in-process entry call."""
    from unittest import mock

    return mock.patch.dict(os.environ, {"DETECTRON2_DATASETS": root})


def check_vlp_cut(device, wrappers, smi):
    """Phase 17b: FocalNet-L + FPN at full width and cut depth (one block a
    stage, 2 decoder and 2 text layers), f32, two random 224^2 images, card
    against CPU: ``evaluate_retrieval_embedding`` within 1e-3; greedy
    ``forward_captioning`` (the raw token table, 512 = 512), every step's
    vocabulary logits replayed teacher-forced on the card's ids within 1e-3
    of their largest entry, each card id within ``LOGIT_TOL`` of its step's
    largest replayed logit, and the ids equal on every row whose every step
    has a top-2 gap above ``LOGIT_TOL`` (phase 6b's rule)."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.models.xdecoder.decoder import xdecoder_forward
    from cullavo_tpu_torch.models.xdecoder.model import (backbone_and_pixel_decoder,
                                                         evaluate_retrieval_embedding,
                                                         init_xdecoder_model_params)
    from cullavo_tpu_torch.pipelines.vlp_pipeline import VLPCaptioningPipeline

    cut = xdecoder_cut(XDEC_FOCAL)
    params = init_xdecoder_model_params(cut, torch.Generator().manual_seed(SEED + 17), "cpu")
    x = np.random.default_rng(SEED + 17).normal(size=(2, VLP_SIDE, VLP_SIDE, 3)).astype(
        np.float32)
    steps = min(cut.decoder.captioning_step, cut.decoder.contxt_len - 1)
    emb, ids, logits = [], None, []
    for dev in (device, torch.device("cpu")):      # the card first: its ids are replayed
        p = _tree_to(params, device=dev)
        pipe = VLPCaptioningPipeline(None, cut, p, None, None, cut.text.vocab_size - 2, VLP_SIDE)
        with torch.inference_mode():
            got, counts = counted(wrappers, lambda: evaluate_retrieval_embedding(
                p, cut, torch.as_tensor(x, device=dev)))
            emb.append([t.float().cpu() for t in got])
            if ids is None:
                ids, _, loop_s = pipe.decode(x)
            ids_dev = torch.as_tensor(ids, device=dev)
            mask_features, pyramid = backbone_and_pixel_decoder(p, cut, torch.as_tensor(
                x, device=dev))
            out = xdecoder_forward(p["decoder"], cut.decoder, pyramid, mask_features,
                                   caption_tokens=pipe.token_embeddings(ids_dev), task="vlp",
                                   is_train=True)
            logits.append((out["pred_captionings"] @ pipe.vocab_table().t())[:, :steps]
                          .float().cpu())
        if dev.type == "cuda" and counts["focal_ctx"] != sum(cut.backbone.depths):
            raise RuntimeError(f"phase 17b: K10 launched {counts['focal_ctx']} times")
    rel_emb = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(emb[0], emb[1]))
    rel = ((logits[0] - logits[1]).abs().max() / logits[1].abs().max()).item()
    top2 = logits[1].topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > LOGIT_TOL).all(dim=1)
    card_ids = torch.as_tensor(ids[:, 1:steps + 1]).long()
    chosen = logits[0].gather(-1, card_ids[..., None])[..., 0]
    own_gap = (logits[0].amax(-1) - chosen).max().item()
    cpu_ids = logits[1].argmax(-1)
    same = [bool(torch.equal(cpu_ids[b], card_ids[b])) for b in range(len(ids))]
    log(f"phase 17b cut ({VLP_SIDE}^2, f32, {steps} steps): card vs CPU retrieval embeddings "
        f"max |d| / max |ref| {rel_emb:.3e}, teacher-forced step logits {rel:.3e} (tol 1e-3); "
        f"largest |logit| {logits[1].abs().max().item():.3e}, card ids below their step's "
        f"largest replayed logit by at most {own_gap:.3e}; rows clear of near-ties "
        f"{clear.tolist()}, ids equal {same}; card decode loop {loop_s:.2f} s")
    if not (rel_emb <= 1e-3 and rel <= 1e-3 and own_gap <= LOGIT_TOL
            and all(s for s, c in zip(same, clear.tolist()) if c)):
        raise RuntimeError(f"phase 17b: the card disagrees with the CPU (embeddings {rel_emb}, "
                           f"logits {rel}, own gap {own_gap}, ids {same}, clear {clear})")


def check_davit_cut(device, smi, davit_dict):
    """Phase 17e: DaViT-d3 + FPN at full width and cut depth (one dual block
    a stage, 2 decoder and 2 text layers), f32, one 256 x 320 image
    (stage 1 is 64 x 80: windows of 12 pad it), card against CPU: res2-res5
    and the class and mask logits within 1e-3 of their largest entry."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
    from cullavo_tpu_torch.models.xdecoder.model import (_backbone_apply, forward_eval,
                                                         init_xdecoder_model_params)

    full = xdecoder_model_config_from(davit_dict)
    cut = dataclasses.replace(
        full, backbone=dataclasses.replace(full.backbone, depths=(1, 1, 1, 1)),
        fpn=dataclasses.replace(full.fpn, enc_layers=1),
        decoder=dataclasses.replace(full.decoder, dec_layers=2),
        text=dataclasses.replace(full.text, layers=2))
    params = init_xdecoder_model_params(cut, torch.Generator().manual_seed(SEED + 18), "cpu")
    h, w = XDEC_CHECK_HW
    rng = np.random.default_rng(SEED + 18)
    x = rng.normal(size=(1, h, w, 3)).astype(np.float32)
    t_emb = rng.normal(size=(cut.num_classes + 1, cut.decoder.dim_proj)).astype(np.float32)
    outs = []
    for dev in (torch.device("cpu"), device):
        p = _tree_to(params, device=dev)
        im = torch.as_tensor(x, device=dev)
        with torch.inference_mode():
            feats = _backbone_apply(p["backbone"], cut, im.permute(0, 3, 1, 2))
            cls, masks, _ = forward_eval(p, cut, im, torch.as_tensor(t_emb, device=dev))
        outs.append({**{k: v.float().cpu() for k, v in feats.items()},
                     "class logits": cls.float().cpu(), "mask logits": masks.float().cpu()})
    rel = {k: ((outs[1][k] - outs[0][k]).abs().max() / outs[0][k].abs().max()).item()
           for k in outs[0]}
    log(f"phase 17e DaViT-d3 cut ({h}x{w}, f32): card vs CPU max |d| / max |ref| "
        f"{ {k: f'{v:.3e}' for k, v in rel.items()} } (tol 1e-3)")
    if not all(v <= 1e-3 for v in rel.values()):
        raise RuntimeError(f"phase 17e: the card disagrees with the CPU: {rel}")


def run_vlp_path(device, wrappers, smi, work, rec, pt_focal):
    """Phase 17: the X-Decoder's VLP eval and the DaViT backbone (in phase
    16's working directory, with its FocalNet-L ``.pt`` and CLIP files).
    (a) a ``DETECTRON2_DATASETS`` root with the karpathy test arrow
    (``write_vlp_dataset``: ``VLP_SIZES``, 48 images of phase 9's sizes,
    PNG bytes, 5-7 captions, two record batches) read back through the
    port's reader, every value equal.  (b) ``check_vlp_cut``.  (c) ``python
    -m cullavo_tpu_torch eval --conf_files configs/xdecoder_test.yaml`` in a
    subprocess (f32) on ``vlp_val`` and ``vlp_captioning_val`` with
    ``RESUME_FROM``, ``MODEL.TEXT.TOKENIZER``, ``SAVE_DIR`` and ``LIMIT``
    16: exit 0, recall in [0, 100], the caption metrics finite, 16 captions
    written.  (d) ``entry.evaluate`` on all 48 rows in bf16 in this
    process, then the first 16 again: equal captions,
    K10 24 times a forward (6
    retrieval and 6 captioning forwards; the first run's counts are
    returned; its timing covers the 5 batches after the first).  (e) DaViT-d3: random
    weights at full width and depth through the inverse table and back
    through ``RESUME_FROM`` bit-equal; ``check_davit_cut``; then
    configs/xdecoder/davitd3_unicl_lang.yaml at full depth in bf16 on phase
    16's ``semseg`` and ``coco_panoptic`` datasets and ``vlp_val``: metrics
    finite and in range, no kernel launched.  (f) load seconds, retrieval
    images/s, captioning seconds a batch and ms a decode step, DaViT-d3
    images/s and compute seconds a batch, peak memory."""
    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.config import load_opt_command
    from cullavo_tpu_torch.data.arrow_ipc import ArrowFile
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from

    t_phase = time.perf_counter()
    tok_dir = os.path.join(work, "clip_tokenizer")
    # (a)
    root = os.path.join(work, "vlp_root")
    t0 = time.perf_counter()
    path, columns = write_vlp_dataset(root, VLP_SIZES, seed=SEED + 17,
                                      batch_rows=VLP_BATCH_ROWS)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    f = ArrowFile(path)
    back = {name: [f.column(name)[i] for i in range(len(f))] for name in columns}
    back["image"] = [bytes(v) for v in back["image"]]
    t_read = time.perf_counter() - t0
    if f.num_batches != -(-len(VLP_SIZES) // VLP_BATCH_ROWS) or any(back[k] != v
                                                          for k, (_, v) in columns.items()):
        raise RuntimeError("phase 17a: the arrow file does not read back equal")
    log(f"phase 17a ({smi}): {path}: {len(f)} rows in {f.num_batches} record batches, "
        f"{os.path.getsize(path) / 2**20:.1f} MiB written in {t_write:.2f} s (PNG encode "
        f"included), read back equal in {t_read:.3f} s")
    del f, back

    # (b)
    check_vlp_cut(device, wrappers, smi)
    torch.cuda.empty_cache()

    # (c) the command line, f32
    over = {"DATASETS.TEST": list(VLP_DATASETS), "MODEL.TEXT.TOKENIZER": tok_dir,
            "BATCH_SIZE": XDEC_BATCH}
    env = dict(os.environ, DETECTRON2_DATASETS=root, PYTHONPATH=os.pathsep.join(
        [REPO] + [q for q in os.environ.get("PYTHONPATH", "").split(os.pathsep) if q]))
    cli_dir = os.path.join(work, "vlp_cli")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "cullavo_tpu_torch"]
                         + xeval_argv(over, "RESUME_FROM", pt_focal, "SAVE_DIR", cli_dir,
                                      "LIMIT", str(VLP_CLI_ROWS)),
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    for line in res.stderr.strip().splitlines()[-4:]:
        log(f"  vlp eval CLI: {line}")
    if res.returncode != 0:
        raise RuntimeError(f"vlp eval: python -m cullavo_tpu_torch exited {res.returncode}")
    cli = json.loads(res.stdout.strip().splitlines()[-1])
    vals = _check_vlp(cli, "vlp eval CLI", VLP_CLI_ROWS)
    caps = _read_captions(cli_dir, VLP_CLI_ROWS)
    log(f"vlp eval CLI ({smi}): exit 0 in {t_cli:.2f} s (process start, checkpoint, 2 "
        f"datasets of {VLP_CLI_ROWS} rows, f32); {vals}; first caption {caps[0]['caption']!r}")

    # (d) in this process, bf16, then the first VLP_CLI_ROWS rows again
    runs = []
    for i in range(2):
        out_dir = os.path.join(work, f"vlp_run{i}")
        n_rows = len(VLP_SIZES) if i == 0 else VLP_CLI_ROWS
        cfg = load_opt_command(xeval_argv(over, "RESUME_FROM", pt_focal, "DTYPE", "bfloat16",
                                          "SAVE_DIR", out_dir, "LIMIT", str(n_rows)))[0].to_dict()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        with _datasets_root(root):
            out, counts = counted(wrappers, lambda: entry.evaluate(cfg, device=device))
        torch.cuda.synchronize(device)
        runs.append((out, counts, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated(device) / 2**30,
                     _read_captions(out_dir, n_rows)))
    (res1, counts, wall, peak, caps1), (res2, _, wall2, _, caps2) = runs
    vals = _check_vlp(res1, "vlp entry.evaluate", len(VLP_SIZES))
    forwards = 2 * -(-len(VLP_SIZES) // XDEC_BATCH)   # retrieval + captioning batches
    blocks = sum(xdecoder_model_config_from(XDEC_CONFIGS[XDEC_FOCAL]).backbone.depths)
    log(f"vlp eval in process ({smi}): {forwards} forwards, launches {counts}")
    if counts["focal_ctx"] != blocks * forwards or sum(counts.values()) != counts["focal_ctx"]:
        raise RuntimeError(f"vlp eval: K10 launched {counts['focal_ctx']} times, not "
                           f"{blocks} x {forwards}: {counts}")
    if caps1[:VLP_CLI_ROWS] != caps2:
        raise RuntimeError(f"two VLP evals' captions differ: {caps1[:2]} {caps2[:2]}")
    timing = {name: r["timing"] for name, r in res1.items()}
    for i, res in enumerate((res1, res2), 1):
        t_ret, t_cap = res["vlp_val"]["timing"], res["vlp_captioning_val"]["timing"]
        log(f"vlp retrieval run {i} ({smi}, bf16, batch {t_ret['eval_batch']}, {VLP_SIDE}^2): "
            f"{t_ret.get('images_per_s', 0.0):.3f} images/s over the {t_ret['batches_timed']} "
            f"batches after the first, compute {t_ret['compute_s']:.4f} s a batch (data "
            f"{t_ret['data_s']:.4f})")
        log(f"vlp captioning run {i} ({smi}, bf16, batch {t_cap['eval_batch']}): "
            f"{t_cap['compute_s']:.4f} s a batch over the {t_cap['batches_timed']} after the "
            f"first (trunk {t_cap['trunk_s']:.4f} s, {t_cap['step_ms']:.2f} ms a decode step), "
            f"{t_cap.get('images_per_s', 0.0):.3f} images/s")
    log(f"vlp eval in process ({smi}): run 1 {wall:.2f} s (checkpoint load, 2 datasets of "
        f"{len(VLP_SIZES)} rows), run 2 {wall2:.2f} s (the first {VLP_CLI_ROWS} rows), their "
        f"captions equal; peak memory {peak:.2f} GiB; {vals}")

    # (e) DaViT-d3
    davit_dict = load_opt_command(["eval", "--conf_files",
                                   os.path.join(REPO, DAVIT_CFG)])[0].to_dict()
    pt_davit, t_load_davit = checkpoint_round_trip(DAVIT_CFG, device, work, smi, davit_dict)
    check_davit_cut(device, smi, davit_dict)
    torch.cuda.empty_cache()
    names = [XEVAL_SEMSEG, XEVAL_PANOPTIC, "vlp_val"]
    cfg = load_opt_command(xeval_argv({"DATASETS.TEST": names, "BATCH_SIZE": XDEC_BATCH,
                                       "EVAL_BATCH": XDEC_BATCH, "MODEL.TEXT.TOKENIZER": tok_dir},
                                      "RESUME_FROM", pt_davit, "DTYPE", "bfloat16",
                                      path_cfg=DAVIT_CFG))[0].to_dict()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with _datasets_root(root):
        dres, dcounts = counted(wrappers, lambda: entry.evaluate(cfg, device=device))
    torch.cuda.synchronize(device)
    d_wall, d_peak = time.perf_counter() - t0, torch.cuda.max_memory_allocated(device) / 2**30
    seg = {"mIoU": dres[XEVAL_SEMSEG]["sem_seg"]["mIoU"],
           "panoptic mIoU": dres[XEVAL_PANOPTIC]["sem_seg"]["mIoU"],
           "PQ": dres[XEVAL_PANOPTIC]["panoptic"]["PQ"],
           **{k: dres["vlp_val"][k] for k in ("ir@1", "tr@1", "ir@10", "tr@10")}}
    if not all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in seg.values()) or any(
            dcounts.values()):
        raise RuntimeError(f"DaViT-d3 eval: metrics {seg}, launches {dcounts}")
    d_timing = {name: r["timing"] for name, r in dres.items()}
    for name, t in d_timing.items():
        log(f"DaViT-d3 eval {name} ({smi}, bf16, batch {t['eval_batch']}): "
            f"{t.get('images_per_s', 0.0):.3f} images/s over the {t['batches_timed']} batches "
            f"after the first, compute {t['compute_s']:.4f} s a batch")
    log(f"DaViT-d3 eval ({smi}): {d_wall:.2f} s (checkpoint load, class embeddings, 3 "
        f"datasets), peak memory {d_peak:.2f} GiB, no kernel launched; {seg}")
    os.remove(pt_davit)
    os.remove(pt_focal)
    rec["focal_ctx"]["vlp_eval"] = {
        "forwards": forwards, "timing": timing, "peak_gib": peak, "cli_s": t_cli,
        "davit_d3": {"checkpoint_load_s": t_load_davit, "timing": d_timing, "peak_gib": d_peak},
        "card": smi}
    log(f"phase 17 in {time.perf_counter() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return counts


def np_isfinite(a):
    import numpy as np

    return bool(np.isfinite(a).all())


def xdecoder_rows(num_classes):
    """The eval set: 16 normalized random images (12 of 512^2, 4 of 480 x
    640) with synthetic ground truth of 64-pixel blocks: a semantic map, a
    panoptic map with one segment per class, up to 4 instance masks."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    rows = []
    for i, (h, w) in enumerate(XDEC_SIZES):
        blocks = rng.integers(0, num_classes, (-(-h // 64), -(-w // 64)))
        sem = np.kron(blocks, np.ones((64, 64), np.int64))[:h, :w]
        cats = np.unique(sem)
        rows.append({
            "image": rng.normal(size=(h, w, 3)).astype(np.float32), "image_id": i,
            "sem_seg": sem, "pan_seg_gt": (sem + 1).astype(np.int32),
            "segments_gt": [{"id": int(c) + 1, "category_id": int(c),
                             "isthing": int(c) in XDEC_THINGS} for c in cats],
            "instances_gt": {"masks": np.stack([sem == c for c in cats[:4]]),
                             "classes": cats[:4]}})
    return rows


def _same(a, b) -> bool:
    """Two nested dicts of numpy arrays hold equal arrays."""
    import numpy as np

    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def check_xdecoder_results(res, batches, num_classes):
    """Ids in range, finite scores and metrics."""
    import numpy as np

    for out in batches:
        if "sem" in out and not (0 <= out["sem"].min() and out["sem"].max() < num_classes):
            raise RuntimeError("semantic ids out of range")
        inst = out["inst"]
        if not (np.isfinite(inst["scores"]).all() and 0 <= inst["classes"].min()
                and inst["classes"].max() < num_classes):
            raise RuntimeError("instance scores or classes out of range")
    for o in res["panoptic_outputs"]:
        ids = {s["id"] for s in o["segments"]}
        if not (set(np.unique(o["panoptic"]).tolist()) <= ids | {0}
                and all(0 <= s["category_id"] < num_classes for s in o["segments"])):
            raise RuntimeError(f"panoptic ids out of range: {o['segments']}")
    metrics = [v for key in ("sem_seg", "panoptic", "instance_ap") for v in res.get(key, {}).values()]
    if "sem_seg" not in res or not all(np.isfinite(v) for v in metrics):
        raise RuntimeError(f"metrics not finite: {res.get('sem_seg')} {res.get('panoptic')} "
                           f"{res.get('instance_ap')}")


def run_xdecoder_path(path, device, wrappers, smi):
    """Phase 9c: one configuration at full width and depth in bf16 (random
    weights from a seeded generator on the card), class embeddings of the
    133 COCO panoptic classes and the background through the 12-layer text
    encoder, then ``XDecoderPipeline.evaluate_model`` with the semantic,
    panoptic and instance tasks on the 16 images at ``EVAL_BATCH`` 8, twice.
    Returns the first run's launch counts and the pipeline."""
    import torch

    from cullavo_tpu_torch.entry import _make_text_tokenize
    from cullavo_tpu_torch.models.from_config import xdecoder_model_config_from
    from cullavo_tpu_torch.models.xdecoder.model import init_xdecoder_model_params
    from cullavo_tpu_torch.models.xdecoder.text_encoder import class_embeddings_ensembled
    from cullavo_tpu_torch.pipelines.base import build_pipeline
    from cullavo_tpu_torch.pipelines.xdecoder_pipeline import tasks_for_dataset
    from cullavo_tpu_torch.utils.constants import COCO_PANOPTIC_CLASSES

    cfg_dict = XDEC_CONFIGS[path]
    model_cfg = xdecoder_model_config_from(cfg_dict)
    t0 = time.perf_counter()
    params = init_xdecoder_model_params(model_cfg, torch.Generator(device=device).manual_seed(SEED),
                                        device, dtype=torch.bfloat16)
    with torch.inference_mode():
        text = class_embeddings_ensembled(params["text"], model_cfg.text,
                                          _make_text_tokenize(cfg_dict, model_cfg.text),
                                          COCO_PANOPTIC_CLASSES, add_background=True)
    torch.cuda.synchronize(device)
    log(f"{path}: bf16 weights and {tuple(text.shape)} class embeddings in "
        f"{time.perf_counter() - t0:.1f} s, {torch.cuda.memory_allocated(device) / 2**30:.2f} GiB "
        "allocated")
    pipe = build_pipeline(cfg_dict["PIPELINE"], cfg_dict, model_cfg=model_cfg, params=params,
                          text_class_embeds=text, tasks=tasks_for_dataset(XDEC_DATASET),
                          eval_batch=XDEC_BATCH)
    rows = xdecoder_rows(model_cfg.num_classes)
    run_batch = pipe._run_batch
    runs = []
    for _ in range(2):
        batches = []

        def recording(*a, _batches=batches):
            out = run_batch(*a)
            _batches.append(out)
            return out

        pipe._run_batch = recording
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res, counts = counted(wrappers, lambda: pipe.evaluate_model(rows, thing_ids=XDEC_THINGS))
        wall = time.perf_counter() - t0
        runs.append((res, batches, counts, wall, torch.cuda.max_memory_allocated(device) / 2**30))
    pipe._run_batch = run_batch
    (res, batches, counts, _, _), (res2, batches2, _, _, _) = runs
    log(f"launches on the {path} eval path: {counts}")
    forwards = len(batches)
    if path == XDEC_FOCAL:
        want = {"focal_ctx": sum(model_cfg.backbone.depths) * forwards, "ms_deform_attn": 0}
    else:
        want = {"ms_deform_attn": model_cfg.fpn.num_layers * forwards, "focal_ctx": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"{path}: launches {counts} != predicted {want} ({forwards} forwards)")
    check_xdecoder_results(res, batches, model_cfg.num_classes)
    pan = [(o["image_id"], o["segments"]) for o in res["panoptic_outputs"]]
    if not (all(_same(a, b) for a, b in zip(batches, batches2)) and len(batches) == len(batches2)
            and pan == [(o["image_id"], o["segments"]) for o in res2["panoptic_outputs"]]):
        raise RuntimeError(f"{path}: two runs gave different outputs")
    n_seg = sum(len(s) for _, s in pan)
    n_inst = sum(len(o["scores"]) for o in res["instance_outputs"])
    n_keep = sum(int(out["pan"]["keep"].sum()) for out in batches)
    log(f"{path}: {len(rows)} images in {forwards} batches of {XDEC_BATCH}; outputs identical "
        f"across the two runs; {n_keep} queries kept for the panoptic map (class score > "
        f"{model_cfg.object_mask_threshold}, not the background) over the batches' "
        f"{forwards * XDEC_BATCH} rows, {n_seg} panoptic segments, {n_inst} instances; sem_seg "
        f"{res['sem_seg']}, panoptic {res.get('panoptic')}, instance AP {res.get('instance_ap')}")
    for i, (r, _, _, wall, peak) in enumerate(runs, 1):
        t = r["timing"]
        log(f"{path} run {i} ({smi}): {t.get('images_per_s', 0.0):.4f} images/s after the first "
            f"batch, compute {t['compute_s']:.4f} s per batch (data {t['data_s']:.4f}, eval "
            f"{t['eval_s']:.4f}), wall {wall:.3f} s, peak memory {peak:.2f} GiB")
    return counts, pipe, rows


def profile_xdecoder(pipe, rows, device):
    """``--profile``: one more 512^2 batch of 8 through the pipeline's
    device part under torch.profiler; the device-busy share of the wall
    time and the kernels by device time."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = rows[:XDEC_BATCH]
    img = np.stack([r["image"] for r in batch])
    hw = np.asarray([r["image"].shape[:2] for r in batch], np.int32)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pipe._run_batch(img, hw, (XDEC_SIDE, XDEC_SIDE))
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile X-Decoder eval batch ({pipe.cfg['NAME']}): wall {wall:.4f} s (profiled), device "
        f"busy {busy:.4f} s ({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=24, max_name_column_width=70))


def _merge_pair(seq, a, b):
    out, i = [], 0
    while i < len(seq):
        if i + 1 < len(seq) and seq[i] == a and seq[i + 1] == b:
            out.append(a + b)
            i += 2
        else:
            out.append(seq[i])
            i += 1
    return out


def write_tokenizer(path, added=((32000, "<image>"), (32001, "<pad>")), n_vocab=None):
    """A LLaMA-style ``tokenizer.json`` (the family llava-hf/llava-1.5-7b-hf
    ships) as plain JSON: <unk>, <s>, </s> at 0-2, the 256 byte-fallback
    tokens <0x00>..<0xFF>, the corpus' characters ("▁" among them), then
    ``TOKENIZER_MERGES`` BPE merges learned here on a small corpus (the most
    frequent pair first); ``added`` (id, token) pairs as added tokens (by
    default <image> and <pad> at 32000 and 32001; the config's pad_token is
    <pad> when it is among them); with ``n_vocab``, filler pieces
    ("▁w" + a number, which no merge makes) up to that many ids, so that a
    random model's ids decode to words; the legacy Prepend/Replace
    normalizer and the Replace, ByteFallback, Fuse, Strip decoder; and its
    tokenizer_config.json."""
    from collections import Counter

    words = ["\u2581" + t.replace(" ", "\u2581") for t in TOKENIZER_CORPUS]
    vocab = (["<unk>", "<s>", "</s>"] + [f"<0x{b:02X}>" for b in range(256)]
             + sorted({c for w in words for c in w}))
    seqs, merges = [list(w) for w in words], []
    for _ in range(TOKENIZER_MERGES):
        counts = Counter(pair for seq in seqs for pair in zip(seq, seq[1:]))
        if not counts:
            break
        (a, b), n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        merges.append(f"{a} {b}")
        if a + b not in vocab:
            vocab.append(a + b)
        seqs = [_merge_pair(seq, a, b) for seq in seqs]
    while n_vocab is not None and len(vocab) < n_vocab:
        vocab.append(f"\u2581w{len(vocab)}")
    added = [(0, "<unk>"), (1, "<s>"), (2, "</s>")] + list(added)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}
                         for i, c in added],
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "\u2581"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "\u2581"}]},
        "pre_tokenizer": None,
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                                    {"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": "<s>", "type_id": 1}},
                                    {"Sequence": {"id": "B", "type_id": 1}}],
                           "special_tokens": {"<s>": {"id": "<s>", "ids": [1],
                                                      "tokens": ["<s>"]}}},
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "\u2581"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {"type": "BPE", "dropout": None, "unk_token": "<unk>",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": True, "byte_fallback": True,
                  "vocab": {t: i for i, t in enumerate(vocab)}, "merges": merges}}
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "LlamaTokenizer", "add_bos_token": True,
                   "add_eos_token": False, "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>",
                   "pad_token": "<pad>" if "<pad>" in dict(added).values() else None,
                   "legacy": False,
                   "clean_up_tokenization_spaces": False, "model_max_length": 4096}, f)
    return len(vocab), len(merges)


def charsmap_pairs():
    """A SentencePiece-style normalisation table (nmt_nfkc's kind of pair):
    full-width ASCII to ASCII, ideographic and no-break spaces to a space,
    ligatures spelled out, a letter + combining mark composed, and the
    ellipsis and trade mark spelled out."""
    import unicodedata

    pairs = {chr(0xFF01 + i): chr(0x21 + i) for i in range(94)}
    pairs.update({"\u3000": " ", "\u00a0": " ", "\ufb00": "ff", "\ufb01": "fi",
                  "\ufb02": "fl", "\ufb03": "ffi", "\u2026": "...", "\u2122": "TM"})
    for base in "aeiouAEIOUnc":
        for mark in "\u0300\u0301\u0302\u0303\u0308\u0327":
            composed = unicodedata.normalize("NFC", base + mark)
            if len(composed) == 1:
                pairs[base + mark] = composed
    return pairs


def _zoo_words():
    """The words and characters the zoo vocabularies are built from."""
    words = set()
    for text in TOKENIZER_CORPUS + VL_QUESTION_TEXT + VL_ANSWERS:
        words.update(text.replace("?", " ?").replace(",", " ,").replace(".", " .").split())
    return sorted(words)


def _unigram_pieces(n, seed, reserved):
    """``n`` (piece, score) pairs: every character of the corpus, "▁" +
    each word and the word's prefixes, then filler pieces, scored from
    ``seed`` (longer corpus pieces score higher per character)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    words = _zoo_words()
    pieces = {"▁": -2.0}
    for c in sorted({c for w in words for c in w} | set("0123456789")):
        pieces.setdefault(c, -4.0 - float(rng.uniform(0, 2)))
    for w in words:
        for k in range(2, len(w) + 1):
            pieces.setdefault("▁" + w[:k], -1.0 - 4.0 / k - float(rng.uniform(0, 1)))
        pieces.setdefault(w, -6.0 - float(rng.uniform(0, 2)))
    items = [(p, s) for p, s in pieces.items() if p not in reserved]
    i = 0
    while len(items) < n:
        items.append((f"▁q{i:x}", -12.0 - float(rng.uniform(0, 4))))
        i += 1
    return items[:n]


KOSMOS_TAGS = ("</doc>", "<image>", "</image>", "</chunk>", "</line>", "<phrase>", "</phrase>",
               "<object>", "</object>", "</delimiter_of_multi_objects/>", "<grounding>")


def write_unigram_tokenizer(path, kind, n_vocab, n_extra=0, n_patch=0, seed=0):
    """A Unigram ``tokenizer.json`` of ``n_vocab`` ids and its configs, as
    the zoo's snapshots ship them, built here (no sentencepiece model):
    ``kind`` "t5" (Salesforce/blip2-flan-t5-xl's T5TokenizerFast: <pad>,
    </s>, <unk>, the pieces, ``n_extra`` <extra_id_N> added tokens; the
    Precompiled normalizer, WhitespaceSplit + Metaspace, "$A </s>") or
    "xlmr" (KOSMOS-2's XLMRobertaTokenizerFast: <s>, <pad>, </s>, <unk>, the
    pieces, <mask>; then KOSMOS-2's 11 tags and ``n_patch``
    <patch_index_NNNN> added tokens; Precompiled + Replace(" {2,}", "▁"),
    Metaspace, "<s> $A </s>"), both with the Metaspace decoder and
    ``charsmap_pairs``' charsmap.  Returns the ids of the special tokens."""
    import base64

    from cullavo_tpu_torch.data.tokenizer_json import write_charsmap

    cmap = base64.b64encode(write_charsmap(charsmap_pairs())).decode()
    meta = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always",
            "split": True}
    if kind == "t5":
        head = ["<pad>", "</s>", "<unk>"]
        tail = [f"<extra_id_{i}>" for i in range(n_extra - 1, -1, -1)]
        n_pieces = n_vocab - len(head) - len(tail)
        vocab = [[t, 0.0] for t in head] + [list(p) for p in _unigram_pieces(
            n_pieces, seed, set(head))]
        added = [(i, t, True) for i, t in enumerate(head)]
        added += [(len(vocab) + i, t, True) for i, t in enumerate(tail)]
        normalizer = {"type": "Precompiled", "precompiled_charsmap": cmap}
        pre = {"type": "Sequence", "pretokenizers": [{"type": "WhitespaceSplit"}, meta]}
        single = [{"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": "</s>", "type_id": 0}}]
        post_specials = {"</s>": {"id": "</s>", "ids": [1], "tokens": ["</s>"]}}
        unk_id = 2
        config = {"tokenizer_class": "T5Tokenizer", "eos_token": "</s>", "unk_token": "<unk>",
                  "pad_token": "<pad>", "extra_ids": n_extra,
                  "additional_special_tokens": tail[::-1], "model_max_length": 512,
                  "clean_up_tokenization_spaces": True}
    elif kind == "xlmr":
        head = ["<s>", "<pad>", "</s>", "<unk>"]
        tags = list(KOSMOS_TAGS) + [f"<patch_index_{i:04d}>" for i in range(n_patch)]
        n_pieces = n_vocab - len(head) - 1 - len(tags)
        vocab = ([[t, 0.0] for t in head]
                 + [list(p) for p in _unigram_pieces(n_pieces, seed, set(head))]
                 + [["<mask>", 0.0]])
        added = [(i, t, True) for i, t in enumerate(head)] + [(len(vocab) - 1, "<mask>", True)]
        added += [(len(vocab) + i, t, False) for i, t in enumerate(tags)]
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": cmap},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]}
        pre = meta
        single = [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                  {"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": "</s>", "type_id": 0}}]
        post_specials = {"<s>": {"id": "<s>", "ids": [0], "tokens": ["<s>"]},
                         "</s>": {"id": "</s>", "ids": [2], "tokens": ["</s>"]}}
        unk_id = 3
        config = {"tokenizer_class": "XLMRobertaTokenizer", "bos_token": "<s>",
                  "eos_token": "</s>", "sep_token": "</s>", "cls_token": "<s>",
                  "unk_token": "<unk>", "pad_token": "<pad>", "mask_token": "<mask>",
                  "model_max_length": 2048, "clean_up_tokenization_spaces": True}
    else:
        raise ValueError(f"unknown Unigram tokenizer kind {kind!r}")
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": i, "content": t, "single_word": False,
                              "lstrip": kind == "xlmr" and not special, "rstrip": False,
                              "normalized": False, "special": special}
                             for i, t, special in added],
            "normalizer": normalizer, "pre_tokenizer": pre,
            "post_processor": {"type": "TemplateProcessing", "single": single,
                               "pair": single + single[-1:], "special_tokens": post_specials},
            "decoder": meta,
            "model": {"type": "Unigram", "unk_id": unk_id, "vocab": vocab,
                      "byte_fallback": False}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(config, f)
    return {t: i for i, t, _ in added}


def write_wordpiece_tokenizer(path, n_vocab, seed=0):
    """A BERT-uncased WordPiece ``tokenizer.json`` of ``n_vocab`` ids plus
    InstructBLIP's added ``[DEC]`` at ``n_vocab`` (the Q-Former's
    qformer_tokenizer/): [PAD], [UNK], [CLS], [SEP], [MASK], the corpus'
    characters and "##" characters, its lower-cased words and "##" suffixes,
    then filler words; the BertNormalizer, the BertPreTokenizer, "[CLS] $A
    [SEP]" and the WordPiece decoder.  Returns the special tokens' ids."""
    import numpy as np

    rng = np.random.default_rng(seed)
    head = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    vocab = list(head)
    words = sorted({w.lower().strip("?,.") for w in _zoo_words()} - {""})
    chars = sorted({c for w in words for c in w} | set("0123456789?,.'"))
    vocab += chars + ["##" + c for c in chars]
    for w in words:
        vocab.append(w)
        if len(w) > 3:
            vocab.append("##" + w[len(w) // 2:])
    vocab = list(dict.fromkeys(vocab))
    i = 0
    while len(vocab) < n_vocab:
        vocab.append(f"w{i:x}{int(rng.integers(0, 16)):x}")
        i += 1
    vocab = vocab[:n_vocab]
    added = [(j, t) for j, t in enumerate(head)] + [(n_vocab, "[DEC]")]
    spec = {"version": "1.0", "truncation": None, "padding": None,
            "added_tokens": [{"id": j, "content": t, "single_word": False, "lstrip": False,
                              "rstrip": False, "normalized": False, "special": True}
                             for j, t in added],
            "normalizer": {"type": "BertNormalizer", "clean_text": True,
                           "handle_chinese_chars": True, "strip_accents": None,
                           "lowercase": True},
            "pre_tokenizer": {"type": "BertPreTokenizer"},
            "post_processor": {"type": "TemplateProcessing",
                               "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                                          {"Sequence": {"id": "A", "type_id": 0}},
                                          {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
                               "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                                        {"Sequence": {"id": "A", "type_id": 0}},
                                        {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                                        {"Sequence": {"id": "B", "type_id": 1}},
                                        {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
                               "special_tokens": {
                                   "[CLS]": {"id": "[CLS]", "ids": [2], "tokens": ["[CLS]"]},
                                   "[SEP]": {"id": "[SEP]", "ids": [3], "tokens": ["[SEP]"]}}},
            "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
            "model": {"type": "WordPiece", "unk_token": "[UNK]",
                      "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                      "vocab": {t: j for j, t in enumerate(vocab)}}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "BertTokenizer", "do_lower_case": True,
                   "tokenize_chinese_chars": True, "strip_accents": None,
                   "unk_token": "[UNK]", "sep_token": "[SEP]", "pad_token": "[PAD]",
                   "cls_token": "[CLS]", "mask_token": "[MASK]", "bos_token": "[DEC]",
                   "model_max_length": 512, "clean_up_tokenization_spaces": True}, f)
    return {t: j for j, t in added}


OPT_SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")   # ids 0-3 of facebook/opt's vocabulary
OPT_TOKENIZER_IDS = 50265                         # its tokenizer; the model's table has 50272


def write_bytelevel_tokenizer(path, n_vocab, merges=TOKENIZER_MERGES):
    """An OPT / GPT-2 style byte-level BPE ``tokenizer.json`` of ``n_vocab``
    ids (OPT's 50265 at the published size): <s>, <pad>, </s>, <unk> at 0-3
    as added special tokens, GPT-2's 256 byte characters, up to ``merges``
    merges learned here on the zoo's words (the most frequent pair first),
    then filler merges of byte-character pairs up to ``n_vocab``; the
    ByteLevel pre-tokenizer (no prefix space) and decoder, OPT's "</s> $A"
    post-processor; its tokenizer_config.json (GPT2Tokenizer, bos / eos /
    unk </s>, pad <pad>).  Returns the special tokens' ids."""
    from collections import Counter

    from cullavo_tpu_torch.data.tokenizer_json import _BYTE_ENC, gpt2_split

    def pieces(text):
        return ["".join(_BYTE_ENC[b] for b in p.encode("utf-8")) for p in gpt2_split(text)]

    byte_chars = [_BYTE_ENC[b] for b in range(256)]
    vocab = list(OPT_SPECIALS) + byte_chars
    seqs = [list(p) for t in TOKENIZER_CORPUS + tuple(_zoo_words()) for p in pieces(" " + t)]
    learned = []
    for _ in range(merges):
        counts = Counter(pair for seq in seqs for pair in zip(seq, seq[1:]))
        if not counts or len(vocab) >= n_vocab:
            break
        (a, b), n = max(counts.items(), key=lambda kv: (kv[1], kv[0]))
        if n < 2:
            break
        learned.append((a, b))
        if a + b not in vocab:
            vocab.append(a + b)
        seqs = [_merge_pair(seq, a, b) for seq in seqs]
    known = set(vocab)
    fill = ((a, b) for a in byte_chars for b in byte_chars if a + b not in known)
    while len(vocab) < n_vocab:
        a, b = next(fill)
        learned.append((a, b))
        vocab.append(a + b)
    spec = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": c, "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": True, "special": True}
                         for i, c in enumerate(OPT_SPECIALS)],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                          "use_regex": True},
        "post_processor": {"type": "TemplateProcessing",
                           "single": [{"SpecialToken": {"id": "</s>", "type_id": 0}},
                                      {"Sequence": {"id": "A", "type_id": 0}}],
                           "pair": [{"SpecialToken": {"id": "</s>", "type_id": 0}},
                                    {"Sequence": {"id": "A", "type_id": 0}},
                                    {"SpecialToken": {"id": "</s>", "type_id": 1}},
                                    {"Sequence": {"id": "B", "type_id": 1}}],
                           "special_tokens": {"</s>": {"id": "</s>", "ids": [2],
                                                       "tokens": ["</s>"]}}},
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "byte_fallback": False,
                  "vocab": {t: i for i, t in enumerate(vocab)},
                  "merges": [f"{a} {b}" for a, b in learned]}}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "GPT2Tokenizer", "add_bos_token": True,
                   "add_prefix_space": False, "bos_token": "</s>", "eos_token": "</s>",
                   "unk_token": "</s>", "pad_token": "<pad>", "errors": "replace",
                   "model_max_length": 1000000000000000019884624838656,
                   "clean_up_tokenization_spaces": False}, f)
    return {t: i for i, t in enumerate(OPT_SPECIALS)}


def write_snapshot(params, cfg, path):
    """A LLaVA snapshot in the HF layout: config.json with ``cfg``'s widths
    (llava-hf/llava-1.5-7b-hf's, or over a Mistral tower with its sliding
    window, llava-hf/bakLlava-v1-hf's), the tokenizer files, and the weights as
    bf16 safetensors shards (``VL_SHARD_LAYERS`` LLM layers each, the rest in
    the first) written by the port's own writer, with the shard index.
    Returns the bytes of weights written."""
    import re

    from cullavo_tpu_torch.checkpoint.hf_import import to_hf_state_dict
    from cullavo_tpu_torch.checkpoint.safetensors_io import write_safetensors

    t, v = cfg.text, cfg.vision
    hf = {"architectures": ["LlavaForConditionalGeneration"], "model_type": "llava",
          "ignore_index": -100, "image_token_index": cfg.image_token_id,
          "pad_token_id": cfg.pad_token_id, "projector_hidden_act": cfg.projector_hidden_act,
          "vision_feature_layer": cfg.vision_feature_layer,
          "vision_feature_select_strategy": cfg.vision_feature_select_strategy,
          "tie_word_embeddings": False, "torch_dtype": "bfloat16", "vocab_size": t.vocab_size,
          "text_config": {"model_type": "llama" if t.sliding_window is None else "mistral",
                          "vocab_size": t.vocab_size,
                          "hidden_size": t.hidden_size, "intermediate_size": t.intermediate_size,
                          "num_hidden_layers": t.num_hidden_layers,
                          "num_attention_heads": t.num_attention_heads,
                          "num_key_value_heads": t.num_key_value_heads,
                          "max_position_embeddings": t.max_position_embeddings,
                          "rms_norm_eps": t.rms_norm_eps, "rope_theta": t.rope_theta,
                          "sliding_window": t.sliding_window},
          "vision_config": {"model_type": "clip_vision_model", "hidden_size": v.hidden_size,
                            "intermediate_size": v.intermediate_size,
                            "num_hidden_layers": v.num_hidden_layers,
                            "num_attention_heads": v.num_attention_heads,
                            "image_size": v.image_size, "patch_size": v.patch_size,
                            "projection_dim": 768, "hidden_act": v.hidden_act}}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    n_vocab, n_merges = write_tokenizer(path, n_vocab=32000 if cfg.text.sliding_window else None)
    shards = {}
    for name, a in to_hf_state_dict(params, cfg).items():
        m = re.match(r"model\.language_model\.layers\.(\d+)\.", name)
        shards.setdefault(1 + int(m.group(1)) // VL_SHARD_LAYERS if m else 0, {})[name] = a
    weight_map, total = {}, 0
    for k in sorted(shards):
        fname = f"model-{k + 1:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(shards[k], os.path.join(path, fname), {"format": "pt"})
        weight_map.update({name: fname for name in shards[k]})
        total += nbytes(*shards[k].values())
    shards.clear()
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)
    log(f"tokenizer.json: {n_vocab} tokens, {n_merges} merges, <image> 32000, <pad> 32001")
    return total


def vqa_records():
    """The in-memory VQA dataset: ``VL_QUESTIONS`` questions on
    ``VL_IMAGES`` random images of four sizes, ten answers each."""
    import numpy as np

    rng = np.random.default_rng(SEED + 9)
    images = [rng.integers(0, 256, VL_IMAGE_HW[i % len(VL_IMAGE_HW)] + (3,), dtype=np.uint8)
              for i in range(VL_IMAGES)]
    return [{"question_id": 1000 + i, "image_id": i % VL_IMAGES, "image": images[i % VL_IMAGES],
             "question": VL_QUESTION_TEXT[i % len(VL_QUESTION_TEXT)],
             "answers": [VL_ANSWERS[(i + j) % len(VL_ANSWERS)] for j in (0,) * 6 + (1,) * 4],
             "question_type": "what", "answer_type": "other"} for i in range(VL_QUESTIONS)]


def _tree_leaves(tree, prefix=""):
    """(path, leaf) of every leaf of a nested dict / list tree (None: none)."""
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in _tree_leaves(v, f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _tree_leaves(v, f"{prefix}{i}/")]
    return [] if tree is None else [(prefix, tree)]


def run_vl_snapshot_path(cfg, device, wrappers, smi, snap):
    """Phase 10: random LLaVA-1.5-7B bf16 weights from a seeded generator on
    the card, written as a snapshot in the HF layout (``write_snapshot``)
    into the directory ``snap`` and read back through the port's loader (the
    config equal, every tensor bit-equal to the written one, before any
    quantization); then ``entry.evaluate`` on configs/vl_test.yaml with
    ``LOAD_PATH`` the snapshot (``BITS: 8``, batch 8, 16 new tokens) over the
    registered in-memory dataset of 16 questions, twice: n = 16, a finite
    overall accuracy in [0, 100], identical answers in both runs'
    vqa_results.json, and K1, K3 and K4 launched (K2 quantizes activations
    only for SmoothQuant-calibrated dicts, which ``BITS: 8`` from a snapshot
    does not make, in either package).  Returns the run's launch counts and
    the written weights (for phase 10b)."""
    import math

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.checkpoint.hf_import import (llava_config_from_json,
                                                        load_llava_safetensors)
    from cullavo_tpu_torch.data.registry import register_dataset
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params
    from cullavo_tpu_torch.ops import nf4
    from cullavo_tpu_torch.pipelines import vqa_pipeline

    params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(SEED + 6), device,
                               dtype=torch.bfloat16)
    records = vqa_records()
    register_dataset(VL_DATASET, lambda: records, {})
    runs = []
    t0 = time.perf_counter()
    total = write_snapshot(params, cfg, snap)
    t_write = time.perf_counter() - t0
    torch.cuda.empty_cache()
    if llava_config_from_json(snap) != cfg:
        raise RuntimeError("the snapshot's config.json does not give back the 7B config")
    t0 = time.perf_counter()
    loaded = load_llava_safetensors(snap, cfg, device=device)
    torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0
    want, got = dict(_tree_leaves(params)), dict(_tree_leaves(loaded))
    bad = [k for k, a in want.items()
           if k not in got or a.dtype != got[k].dtype or a.shape != got[k].shape
           or not torch.equal(a.view(torch.int16), got[k].view(torch.int16))]
    log(f"snapshot: {total / 1e9:.3f} GB of bf16 weights in "
        f"{len([f for f in os.listdir(snap) if f.endswith('.safetensors')])} shards, "
        f"written in {t_write:.2f} s, loaded onto the card in {t_load:.2f} s "
        f"({total / 1e9 / t_load:.2f} GB/s); {len(got)} tensors, mismatching {len(bad)} "
        "(bit-equal demanded)")
    if bad or len(want) != len(got):
        raise RuntimeError(f"the loaded snapshot differs from the written weights: {bad[:5]}")
    del loaded, want, got
    torch.cuda.empty_cache()
    # time the load (+ quantization), the prefills and the decodes of
    # each run through the module functions the entry and the pipeline call
    timers = {"build": (entry, "_build_llava"),
              "prefill": (vqa_pipeline, "generate_prefill_chunked"),
              "decode": (vqa_pipeline, "generate_decode")}
    spent = {k: [] for k in timers}
    shapes = []

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(device)
            spent[key].append(time.perf_counter() - t)
            if key == "prefill":
                shapes.append(tuple(a[2].shape))
            return out
        return run

    originals = {k: getattr(mod, name) for k, (mod, name) in timers.items()}
    for k, (mod, name) in timers.items():
        setattr(mod, name, timed(k, originals[k]))
    # K3's launches by M (rows of x): the prefill's M = 5632 and the decode's
    k3_by_m = collections.Counter()
    k3_cuda = nf4._int8_linear_cuda

    def k3_tally(x, q):
        k3_by_m[x.numel() // x.shape[-1]] += 1
        return k3_cuda(x, q)

    nf4._int8_linear_cuda = k3_tally
    for i in range(2):
        out_dir = os.path.join(snap, f"out{i}")
        vl = {**VL_CFG, "MODEL": {"LLM": {**VL_CFG["MODEL"]["LLM"], "LOAD_PATH": snap}},
              "DATASETS": {"TEST": [VL_DATASET]}, "SAVE_DIR": out_dir}
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res, counts = counted(wrappers, lambda: entry.evaluate(vl))
        wall = time.perf_counter() - t0
        with open(os.path.join(out_dir, "vqa_results.json")) as f:
            answers = json.load(f)
        runs.append((res[VL_DATASET], counts, wall, {k: sum(v) for k, v in spent.items()},
                     answers, torch.cuda.max_memory_allocated(device) / 2**30))
        for v in spent.values():
            v.clear()
        torch.cuda.empty_cache()
    for k, (mod, name) in timers.items():
        setattr(mod, name, originals[k])
    nf4._int8_linear_cuda = k3_cuda
    (res, counts, _, _, answers, _), (res2, _, _, _, answers2, _) = runs
    log(f"launches on the vl_test path: {counts}")
    if not (res["n"] == VL_QUESTIONS and math.isfinite(res["overall"])
            and 0.0 <= res["overall"] <= 100.0 and len(answers) == VL_QUESTIONS):
        raise RuntimeError(f"vl_test: bad metrics {res}")
    if answers != answers2 or res != res2:
        raise RuntimeError("vl_test: two runs gave different answers")
    if not all(counts[k] for k in ("flash_fwd", "int8_linear", "wwin_decode")):
        raise RuntimeError(f"vl_test: a kernel of the path never launched: {counts}")
    log(f"vl_test: {res}; answers identical across the two runs; answers[:3] "
        f"{[a['answer'] for a in answers[:3]]}")
    log(f"vl_test prefill shapes (ids [rows, bucket]): {shapes[:2]}")
    prefill_m = {m: n for m, n in k3_by_m.items() if m >= 1024}
    log(f"vl_test K3 launches by M over both runs: {dict(sorted(k3_by_m.items()))}; at the "
        f"prefill M: {prefill_m}")
    if not prefill_m:
        raise RuntimeError("vl_test: no prefill linear went through K3")
    for i, (_, _, wall, t, _, peak) in enumerate(runs, 1):
        ev = wall - t["build"]
        log(f"vl_test run {i} ({smi}): snapshot load + int8 quantization {t['build']:.3f} s, "
            f"eval {ev:.3f} s (prefill {t['prefill']:.3f} s, decode {t['decode']:.3f} s, the "
            f"rest on the host {ev - t['prefill'] - t['decode']:.3f} s), "
            f"{VL_QUESTIONS / ev:.4f} images/s (eval only), {VL_QUESTIONS / wall:.4f} images/s "
            f"with the load, peak memory {peak:.2f} GiB")
    return counts, params


def run_q4_path(params, cfg, device, requests, wrappers, smi):
    """Phase 10b: phase 10's bf16 weights with the seven LLM targets quantized
    to byte-packed NF4 (``quantize_linear``, q4) and, for comparison, to
    planar NF4.  One target's dequantized weight through K11 bit-equal to
    K7's, its codes and scales equal across the layouts; phase 5's 2-layer
    check on the q4 base (card K11 against the CPU plain path, within 0.1);
    the 14-request greedy batch of phase 6 over the q4 base twice (tokens in
    the vocabulary, equal across runs, K11 launched as the shapes predict:
    7 x 32 x 15 fused at the decode M = 14, 7 x 32 per prefill chunk through
    the dequant entry); every row whose top-2 logit gaps all exceed 0.1 equal
    to the stream over the planar base.  Returns the run's launch counts."""
    import torch

    from cullavo_tpu_torch.models.llava.lora import LLM_TARGETS
    from cullavo_tpu_torch.ops import nf4

    lm = params["language_model"]
    q4, planar = dict(lm["layers"]), dict(lm["layers"])
    t0 = time.perf_counter()
    for t in LLM_TARGETS:
        q4[t] = nf4.quantize_linear(lm["layers"][t])
        planar[t] = nf4.quantize_linear_planar(lm["layers"][t])
    torch.cuda.synchronize(device)
    log(f"q4 and planar NF4 bases quantized on the card in {time.perf_counter() - t0:.2f} s")
    K, N = lm["layers"]["gate"].shape[-2:]
    a, b = {k: v[0] for k, v in q4["gate"].items()}, {k: v[0] for k, v in planar["gate"].items()}
    deq_q4, deq_planar = nf4.nf4_dequant_q4(a, K), nf4.nf4_dequant_planar(b)
    codes_q4 = nf4._unpack_nibbles(a["q4"]).reshape(K, N)
    codes_planar = torch.cat([(b["q4p"] >> (4 * i)) & 0xF for i in range(8)], dim=0)
    same = (torch.equal(deq_q4.view(torch.int16), deq_planar.view(torch.int16))
            and torch.equal(codes_q4, codes_planar.long())
            and torch.equal(a["scale"].reshape(K, N // 64), b["scale"]))
    log(f"gate of layer 0 [{K}, {N}]: K11 dequant {'bit-equal to' if same else 'DIFFERS from'} "
        "K7, codes and scales equal across the two layouts")
    if not same:
        raise RuntimeError("the q4 and planar layouts disagree on one weight")
    del deq_q4, deq_planar, codes_q4, codes_planar
    p_q4 = {**params, "language_model": {**lm, "layers": q4}}
    p_planar = {**params, "language_model": {**lm, "layers": planar}}
    reference_check_nf4(p_q4, cfg, device, label="q4")
    run = make_run(p_q4, cfg, device, requests)
    torch.cuda.reset_peak_memory_stats(device)
    (tok1, pre1, dec1, _), counts = counted(wrappers, run)
    tok2, pre2, dec2, _ = run()
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    check_tokens(tok1, cfg.text.vocab_size)
    if not torch.equal(tok1, tok2):
        raise RuntimeError("two runs of the q4 batch gave different tokens")
    L, n = cfg.text.num_hidden_layers, len(LLM_TARGETS)
    want = {"nf4_linear_q4": n * L * (NEW_TOKENS - 1),
            "nf4_dequant_q4": n * L * -(-BATCH // CHUNK)}
    log(f"launches on the q4 greedy path: {counts}; K11 predicted {want}")
    if any(counts[k] != v for k, v in want.items()):
        raise RuntimeError(f"K11 launches {counts} != predicted {want}")
    tok_p = make_run(p_planar, cfg, device, requests)()[0]
    _, gap = replay(p_q4, cfg, device, requests, tok1, None)
    rows_same = (tok1 == tok_p).all(dim=1)
    decisive = gap.min(dim=1).values > LOGIT_TOL
    log(f"q4 vs planar base: {int(rows_same.sum())} of {BATCH} rows equal; {int(decisive.sum())} "
        f"rows have every top-2 gap above {LOGIT_TOL}, {int((decisive & rows_same).sum())} of "
        "them equal")
    if not (rows_same | ~decisive).all():
        raise RuntimeError("a decisive row of the q4 base left the planar base's stream")
    for i, (pre, dec) in enumerate(((pre1, dec1), (pre2, dec2)), 1):
        log(f"q4 greedy run {i} ({smi}): prefill {pre:.4f} s, decode {dec:.4f} s "
            f"({dec / (NEW_TOKENS - 1) * 1e3:.3f} ms per decode step), "
            f"{BATCH / (pre + dec):.4f} images/s, peak memory {peak:.2f} GiB")
    return counts


def zoo_records():
    """``ZOO_QUESTIONS`` VQA-shaped questions on ``ZOO_IMAGES`` random
    224^2 images, ten answers each."""
    import numpy as np

    rng = np.random.default_rng(SEED + 11)
    images = [rng.integers(0, 256, (ZOO_SIDE, ZOO_SIDE, 3), dtype=np.uint8)
              for _ in range(ZOO_IMAGES)]
    return [{"question_id": 2000 + i, "image_id": i % ZOO_IMAGES, "image": images[i % ZOO_IMAGES],
             "question": VL_QUESTION_TEXT[i % len(VL_QUESTION_TEXT)],
             "answers": [VL_ANSWERS[(i + j) % len(VL_ANSWERS)] for j in (0,) * 6 + (1,) * 4],
             "question_type": "what", "answer_type": "other"} for i in range(ZOO_QUESTIONS)]


def _zoo_models():
    """(name, config, initializer, answerer factory, decoder layers) of the
    two zoo towers, at the published widths and depths."""
    from cullavo_tpu_torch.models import kosmos2 as k2
    from cullavo_tpu_torch.models.blip2 import blip2_flant5xl_config, init_blip2_params
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo

    b2 = blip2_flant5xl_config()
    kc = k2.Kosmos2Config()
    return (("blip2", b2, init_blip2_params, zoo.native_blip2_answer_fn, b2.text.num_decoder_layers),
            ("kosmos2", kc, k2.init_kosmos2_params, zoo.native_kosmos2_answer_fn, kc.text.layers))


def _cut_zoo_config(name, cfg):
    r = dataclasses.replace
    if name == "blip2":
        return r(cfg, vision=r(cfg.vision, num_hidden_layers=ZOO_CUT),
                 qformer=r(cfg.qformer, num_hidden_layers=ZOO_CUT),
                 text=r(cfg.text, num_layers=ZOO_CUT, num_decoder_layers=ZOO_CUT))
    return r(cfg, vision=r(cfg.vision, num_hidden_layers=ZOO_CUT),
             text=r(cfg.text, layers=ZOO_CUT))


def _zoo_probe(name, cfg, params, inputs):
    """The forward's logits and the hidden states of four one-token decode
    steps over the cache (K12 on the card), on one device."""
    import torch

    from cullavo_tpu_torch.models import kosmos2 as k2
    from cullavo_tpu_torch.models.blip2 import modeling as b2m
    from cullavo_tpu_torch.models.blip2 import t5 as t5m

    pix, ids, dec = inputs
    dev = pix.device
    mask = torch.ones_like(ids)
    steps = []
    if name == "blip2":
        logits = b2m.blip2_forward(params, cfg, pix, ids, mask, decoder_input_ids=dec)
        lm = params["language_model"]
        embeds, emask = b2m._prefix_inputs(params, b2m.encode_image(params, cfg, pix), ids, mask)
        enc = t5m.t5_encode(lm, cfg.text, embeds, emask)
        cache = t5m.t5_init_cache(cfg.text, 1, dec.shape[1], enc.dtype, dev)
        for i in range(dec.shape[1]):
            h, cache = t5m.t5_decode_step(lm, cfg.text, lm["embed_tokens"][dec[:, i:i + 1]], enc,
                                          emask, torch.tensor([i], device=dev), cache, i,
                                          stale_cache=True)
            steps.append(h[:, 0])
        return logits, torch.stack(steps, 1)
    n_img, T = cfg.latent_query_num, ids.shape[1]
    img_mask = torch.zeros_like(ids)
    img_mask[:, 1:1 + n_img] = 1
    logits = k2.kosmos2_forward(params, cfg, pix, ids, img_mask, mask)
    emb = k2._scatter_image_embeds(params["embed_tokens"][ids],
                                   k2.kosmos2_image_features(params, cfg, pix), img_mask != 0)
    n = dec.shape[1]
    full = torch.cat([mask, torch.zeros((1, n), dtype=mask.dtype, device=dev)], dim=1)
    pos = k2.kosmos2_position_ids(mask, cfg.text.pad_token_id)
    key_pos = torch.cat([pos, torch.zeros((1, n), dtype=pos.dtype, device=dev)], dim=1)
    cache = k2.kosmos2_init_cache(cfg.text, 1, T + n, emb.dtype, dev)
    k2.kosmos2_text_forward(params, cfg.text, emb, full, pos, cache, 0, key_pos)
    for i in range(n):
        p = pos[:, -1:] + 1 + i
        h, cache = k2.kosmos2_text_forward(params, cfg.text, params["embed_tokens"][dec[:, i:i + 1]],
                                           full, p, cache, T + i, key_pos, stale_cache=True)
        full[:, T + i] = 1
        key_pos[:, T + i] = p[:, 0]
        steps.append(h[:, 0])
    return logits, torch.stack(steps, 1)


def reference_check_zoo(device, wrappers):
    """Phase 11's card-vs-CPU check: each zoo model at full width and
    ``ZOO_CUT`` layers per tower: the forward's logits and four decode
    steps' hidden states (K12 on the card, its plain version on the CPU),
    f32 on the card (TF32 off) against f64 on the CPU (the softmaxes and
    K12's plain version stay f32, as the models compute them), within ``ZOO_TOL``
    times the CPU's own f32 error plus 1e-5 of the largest entry.  The
    measure is relative because the random-weight T5 is sensitive: its
    unscaled attention scores reach about +-100, and the CPU's f32 result
    alone differs from f64 by about 2.6e-4 of the largest logit (KOSMOS-2:
    about 2e-7)."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo
    from cullavo_tpu_torch.utils.tree import tree_map

    tok = ByteTokenizer()
    for name, cfg, init, _, _ in _zoo_models():
        cut = _cut_zoo_config(name, cfg)
        params = init(cut, torch.Generator(device=device).manual_seed(SEED + 12), device)
        vocab = cut.text.vocab_size
        ids = zoo._fold_ids(np.asarray(tok.encode("Question: What is on the table? Answer:")),
                            vocab).tolist()
        if name == "kosmos2":
            ids = [1] + [3] * cut.latent_query_num + ids
        ids = torch.tensor([ids], device=device)
        g = torch.Generator(device=device).manual_seed(SEED + 13)
        pix = torch.randn((1, 3, ZOO_SIDE, ZOO_SIDE), generator=g, device=device)
        dec = torch.randint(4, min(vocab, 260), (1, 4), generator=g, device=device)
        inputs = (pix, ids, dec)
        got, counts = counted(wrappers, lambda: _zoo_probe(name, cut, params, inputs))
        cpu_inputs = tuple(t.cpu() for t in inputs)
        cpu = tree_map(lambda t: t.cpu(), params)
        want32 = _zoo_probe(name, cut, cpu, cpu_inputs)
        cpu = tree_map(lambda t: t.double(), cpu)
        want = _zoo_probe(name, cut, cpu, (cpu_inputs[0].double(), *cpu_inputs[1:]))
        for what, a, r32, r in zip(("logits", "decode-step hidden states"), got, want32, want):
            err = (a.cpu().double() - r).abs().max().item()
            err_cpu = (r32.double() - r).abs().max().item()
            scale = r.abs().max().item()
            tol = ZOO_TOL * err_cpu + 1e-5 * scale
            log(f"{name} card (f32) vs CPU (f64), {ZOO_CUT} layers per tower at full width, "
                f"{what} {tuple(r.shape)}: max_abs_err={err:.3e}; the CPU's f32 {err_cpu:.3e}; "
                f"max |ref| {scale:.3f}; tol {tol:.3e}")
            if not (torch.isfinite(a).all() and err <= tol):
                raise RuntimeError(f"{name}: the card disagrees with the CPU on {what}: {err}")
        if counts["flash_decode"] != ZOO_CUT * dec.shape[1]:
            raise RuntimeError(f"{name} check: K12 launched {counts['flash_decode']} times, "
                               f"expected {ZOO_CUT * dec.shape[1]}")
        del params, cpu
        torch.cuda.empty_cache()


def zoo_entry_smoke(device, wrappers):
    """``entry.evaluate`` with ``MODEL.ZOO: blip2`` and ``kosmos2`` at the
    JAX package's tiny configs (the checkpoint-free path) on the card, over
    four of phase 11's questions: n = 4, an accuracy in [0, 100], K12
    launched."""
    import math

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.data.registry import register_dataset

    records = zoo_records()
    register_dataset(ZOO_DATASET, lambda: records, {})
    for zoo_name in ("blip2", "kosmos2"):
        cfg = {"NAME": "vl_test", "MAX_NEW_TOKENS": ZOO_NEW, "LIMIT": 4,
               "MODEL": {"ZOO": zoo_name}, "DATASETS": {"TEST": [ZOO_DATASET]}}
        res, counts = counted(wrappers, lambda: entry.evaluate(cfg))
        r = res[ZOO_DATASET]
        log(f"entry.evaluate MODEL.ZOO {zoo_name} (tiny config, card): {r}; K12 launches "
            f"{counts['flash_decode']}")
        if not (r["n"] == 4 and math.isfinite(r["overall"]) and 0 <= r["overall"] <= 100
                and counts["flash_decode"] > 0):
            raise RuntimeError(f"entry.evaluate MODEL.ZOO {zoo_name}: {r}, {counts}")


def run_zoo_path(device, wrappers, smi, profile):
    """Phase 11: each zoo model at full width and depth in f32 with seeded
    random weights built on the card answers ``ZOO_QUESTIONS`` questions
    (CLIP-preprocessed at 224^2 beforehand, as ``entry.evaluate``'s mapper
    does) through ``VLZooVQAPipeline.evaluate_model`` with its native
    answerer and the byte tokenizer, then the first ``ZOO_SECOND`` again:
    n = 8, a finite accuracy, the second run's answers and tokens equal to
    the first's, and K12 launched as the shapes predict (BLIP-2:
    decoder layers x 10 beam steps x questions; KOSMOS-2: decoder layers x
    the greedy steps each question ran, one per token up to its first eos).
    Prints questions/s, ms per question by phase, peak memory and K12's
    launches.  Returns the K12 launches of the two models' first runs."""
    import math

    import torch

    from cullavo_tpu_torch.data.mappers.eval_mappers import VQAEvalMapper
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models import kosmos2 as k2
    from cullavo_tpu_torch.models.blip2 import modeling as b2m
    from cullavo_tpu_torch.models.blip2 import t5 as t5m
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo
    from cullavo_tpu_torch.utils.tree import tree_leaves

    mapper = VQAEvalMapper(image_size=ZOO_SIDE)
    rows = []
    for rec in zoo_records():
        m = mapper(rec)
        m["image"] = m.pop("pixel_values")
        rows.append(m)
    total = {}
    for name, cfg, init, answer_fn, n_layers in _zoo_models():
        t0 = time.perf_counter()
        params = init(cfg, torch.Generator(device=device).manual_seed(SEED + 14), device)
        torch.cuda.synchronize(device)
        n_params = sum(t.numel() for t in tree_leaves(params))
        log(f"{name}: {n_params / 1e9:.3f} G parameters in f32 built on the card in "
            f"{time.perf_counter() - t0:.1f} s")
        fn = answer_fn(cfg, params, ByteTokenizer(), max_new_tokens=ZOO_NEW)
        # phase timers around the module functions the answerer reaches
        if name == "blip2":
            timers = {"answer": (zoo, "blip2_beam_generate"), "vision": (b2m, "encode_image"),
                      "encoder": (t5m, "t5_encode")}
        else:
            timers = {"answer": (zoo, "kosmos2_generate"),
                      "vision": (k2, "kosmos2_image_features"), "text": (k2, "kosmos2_text_forward")}
        spent = dict.fromkeys(("answer", "vision", "encoder"), 0.0)
        outs = []

        def timed(key, fn_):
            def run(*a, **kw):
                torch.cuda.synchronize(device)
                t = time.perf_counter()
                out = fn_(*a, **kw)
                torch.cuda.synchronize(device)
                dt = time.perf_counter() - t
                if key != "text":
                    spent[key] += dt
                elif not kw.get("stale_cache"):     # the prompt's cached forward
                    spent["encoder"] += dt
                if key == "answer":
                    outs.append(out.cpu())
                return out
            return run

        originals = {k: getattr(mod, attr) for k, (mod, attr) in timers.items()}
        for k, (mod, attr) in timers.items():
            setattr(mod, attr, timed(k, originals[k]))
        runs = []
        for i in range(2):   # the second run over the first ZOO_SECOND questions
            pipe = zoo.VLZooVQAPipeline(None, name, answer_fn=fn)
            spent.update(dict.fromkeys(spent, 0.0))
            outs.clear()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res, counts = counted(wrappers, lambda: pipe.evaluate_model(
                rows if i == 0 else rows[:ZOO_SECOND]))
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
            runs.append((res, counts, wall, dict(spent), list(outs),
                         [r["answer"] for r in pipe.evaluator.results],
                         torch.cuda.max_memory_allocated(device) / 2**30))
        for k, (mod, attr) in timers.items():
            setattr(mod, attr, originals[k])
        (res, counts, _, _, toks, answers, _), (res2, _, _, _, toks2, answers2, _) = runs
        if name == "blip2":
            want = n_layers * ZOO_NEW * ZOO_QUESTIONS
        else:   # greedy with the early stop: one step per token up to the first eos
            steps = [int((o[0] == 2).nonzero()[0]) + 1 if (o[0] == 2).any() else ZOO_NEW
                     for o in toks]
            want = n_layers * sum(steps)
        log(f"launches on the {name} zoo path: {counts}; K12 predicted {want}")
        if counts["flash_decode"] != want:
            raise RuntimeError(f"{name}: K12 launched {counts['flash_decode']} times, not {want}")
        if not (res["n"] == ZOO_QUESTIONS and math.isfinite(res["overall"])
                and 0.0 <= res["overall"] <= 100.0):
            raise RuntimeError(f"{name}: bad metrics {res}")
        if answers[:ZOO_SECOND] != answers2 or res2["n"] != ZOO_SECOND or len(toks2) != ZOO_SECOND \
                or not all(torch.equal(a, b) for a, b in zip(toks, toks2)):
            raise RuntimeError(f"{name}: two runs gave different answers")
        log(f"{name}: {res}; the second run's {ZOO_SECOND} answers identical; answers[:3] "
            f"{answers[:3]}")
        for i, (r, c, wall, t, _, _, peak) in enumerate(runs, 1):
            n_q = r["n"]
            per_q = 1e3 / n_q
            decode = t["answer"] - t["vision"] - t["encoder"]
            log(f"{name} run {i} ({smi}): {n_q / wall:.4f} questions/s "
                f"({wall:.3f} s for {n_q}); ms per question: vision + "
                f"{'Q-Former/projection' if name == 'blip2' else 'latent-query projection'} "
                f"{t['vision'] * per_q:.2f}, {'T5 encoder' if name == 'blip2' else 'prompt prefill'} "
                f"{t['encoder'] * per_q:.2f}, decode {decode * per_q:.2f}, the rest (host: "
                f"tokenizer, pipeline, scoring) {(wall - t['answer']) * per_q:.2f}; peak memory "
                f"{peak:.2f} GiB; K12 launches {c['flash_decode']}")
        total[name] = counts["flash_decode"]
        if profile:
            profile_zoo(name, fn, rows[0])
        del params, fn, pipe
        torch.cuda.empty_cache()
    return total


def profile_zoo(name, fn, row):
    """``--profile``: one more answer under torch.profiler; the device-busy
    share of its wall time and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn(row["question"], row["image"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    busy = device_seconds(ka)
    log(f"profile {name} one answer: wall {wall:.4f} s (profiled), device busy {busy:.4f} s "
        f"({100 * busy / wall:.1f}%)")
    log(ka.table(sort_by="self_device_time_total", row_limit=18, max_name_column_width=70))


def _ib_probe(cfg, params, inputs):
    """InstructBLIP's forward logits (the instruction into the Q-Former) and
    the logits of the prefill's last position and of decode steps over the
    cache (K12 on the card in f32), on one device."""
    import torch

    from cullavo_tpu_torch.models.blip2 import modeling as b2m

    pix, ids, qids, dec = inputs
    mask, qmask = torch.ones_like(ids), torch.ones_like(qids)
    logits = b2m.blip2_forward(params, cfg, pix, ids, mask, qids, qmask)
    lang_img = b2m.encode_image(params, cfg, pix, qids, qmask)
    embeds, mask0 = b2m._prefix_inputs(params, lang_img, ids, mask)
    cache, full_mask, key_pos, first, last_pos = b2m._prefill(params, cfg, embeds, mask0,
                                                             dec.shape[1] + 1)
    steps, T = [first], mask0.shape[1]
    for i in range(dec.shape[1]):
        last_pos = last_pos + 1
        steps.append(b2m._step(params, cfg, dec[:, i], cache, full_mask, key_pos, T + i,
                               last_pos, embeds.dtype))
    return logits, torch.stack(steps, 1)


def _cut_depth_check(label, probe, cfg, params, inputs, device, wrappers, want_launches):
    """``probe`` at cut depth: f32 on the card (TF32 off) against f64 on the
    CPU (the softmaxes and K12's plain version stay f32), within ``ZOO_TOL``
    times the CPU's own f32 error + 1e-5 of the largest entry, as phase 11
    holds the zoo; the kernels launched as ``want_launches`` says."""
    import torch

    from cullavo_tpu_torch.utils.tree import tree_map

    got, counts = counted(wrappers, lambda: probe(cfg, params, inputs))
    cpu = tree_map(lambda t: t.cpu(), params)
    cpu_in = tuple(t.cpu() for t in inputs)
    want32 = probe(cfg, cpu, cpu_in)
    cpu = tree_map(lambda t: t.double(), cpu)
    want = probe(cfg, cpu, tuple(t.double() if t.is_floating_point() else t for t in cpu_in))
    for i, (a, r32, r) in enumerate(zip(got, want32, want)):
        err = (a.cpu().double() - r).abs().max().item()
        err_cpu = (r32.double() - r).abs().max().item()
        scale = r.abs().max().item()
        tol = ZOO_TOL * err_cpu + 1e-5 * scale
        log(f"{label} card (f32) vs CPU (f64), output {i} {tuple(r.shape)}: max_abs_err="
            f"{err:.3e}; the CPU's f32 {err_cpu:.3e}; max |ref| {scale:.3f}; tol {tol:.3e}")
        if not (torch.isfinite(a).all() and err <= tol):
            raise RuntimeError(f"{label}: the card disagrees with the CPU on output {i}: {err}")
    bad = {k: (counts[k], n) for k, n in want_launches.items() if counts[k] != n}
    if bad:
        raise RuntimeError(f"{label}: launches (got, predicted) {bad}")


def _phase_timers(timers, spent, device):
    """Wrap each ``(module, attribute)`` of ``timers`` so that its calls add
    their synchronised seconds to ``spent[key]``; returns the restore."""
    import torch

    originals = {k: getattr(mod, attr) for k, (mod, attr) in timers.items()}

    def timed(key, fn):
        def run(*a, **kw):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(device)
            spent[key] += time.perf_counter() - t
            return out
        return run

    for k, (mod, attr) in timers.items():
        setattr(mod, attr, timed(k, originals[k]))

    def restore():
        for k, (mod, attr) in timers.items():
            setattr(mod, attr, originals[k])
    return restore


def run_instructblip_path(device, wrappers, smi, work, profile=False):
    """Phase 19a and 19b on one tower, Salesforce/instructblip-vicuna-7b at
    full width and depth in f32 (7.9 G random parameters built on the card).
    19a: a card-vs-CPU check at ``ZOO_CUT`` layers per tower (forward logits
    with the instruction into the Q-Former, the prefill's last logits and
    four decode steps, K12 ``ZOO_CUT`` x 4); ``entry.evaluate`` with
    ``MODEL.ZOO: instructblip`` (JAX's tiny smoke tower) on 4 questions;
    then ``ZOO_QUESTIONS`` questions through ``VLZooVQAPipeline`` with the
    native answerer (beam 5, length penalty -1, ``ZOO_NEW`` tokens, the byte
    tokenizer), then the first ``ZOO_SECOND`` again: n = 8, a finite
    accuracy, identical answers, K12 launched 32 layers x 9 beam steps x
    8; questions/s, ms per question by
    phase and peak memory (``profile``: one more answer under
    torch.profiler).  19b: ``run_imagenet_path`` on the same vision tower
    and Q-Former.  Returns the launches of 19a's first run."""
    import math

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.data.mappers.eval_mappers import VQAEvalMapper
    from cullavo_tpu_torch.data.registry import list_datasets, register_dataset
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.blip2 import modeling as b2m
    from cullavo_tpu_torch.models.blip2 import instructblip_vicuna7b_config, init_blip2_params
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo
    from cullavo_tpu_torch.utils.tree import tree_leaves

    cfg = instructblip_vicuna7b_config()
    r = dataclasses.replace
    cut = r(cfg, vision=r(cfg.vision, num_hidden_layers=ZOO_CUT),
            qformer=r(cfg.qformer, num_hidden_layers=ZOO_CUT),
            text=r(cfg.text, num_hidden_layers=ZOO_CUT))
    params = init_blip2_params(cut, torch.Generator(device=device).manual_seed(SEED + 21), device)
    tok = ByteTokenizer()
    text = zoo.MODEL_SPECS["instructblip"].prompt.format(q=VL_QUESTION_TEXT[0])
    ids = torch.tensor([tok.encode(text)], device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 22)
    inputs = (torch.randn((1, 3, ZOO_SIDE, ZOO_SIDE), generator=g, device=device), ids, ids,
              torch.randint(4, 260, (1, 4), generator=g, device=device))
    _cut_depth_check("InstructBLIP", _ib_probe, cut, params, inputs, device, wrappers,
                     {"flash_decode": ZOO_CUT * 4})
    del params
    torch.cuda.empty_cache()

    if ZOO_DATASET not in list_datasets():
        records = zoo_records()
        register_dataset(ZOO_DATASET, lambda: records, {})
    res, counts = counted(wrappers, lambda: entry.evaluate(
        {"NAME": "vl_test", "MAX_NEW_TOKENS": ZOO_NEW, "LIMIT": 4,
         "MODEL": {"ZOO": "instructblip"}, "DATASETS": {"TEST": [ZOO_DATASET]}}))
    rr = res[ZOO_DATASET]
    log(f"entry.evaluate MODEL.ZOO instructblip (tiny config, card): {rr}; K12 launches "
        f"{counts['flash_decode']}")
    if not (rr["n"] == 4 and math.isfinite(rr["overall"]) and 0 <= rr["overall"] <= 100
            and counts["flash_decode"] > 0):
        raise RuntimeError(f"entry.evaluate MODEL.ZOO instructblip: {rr}, {counts}")

    t0 = time.perf_counter()
    params = init_blip2_params(cfg, torch.Generator(device=device).manual_seed(SEED + 23), device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"instructblip-vicuna-7b: {n_params / 1e9:.3f} G parameters in f32 built on the card in "
        f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated(device) / 2**30:.2f} "
        "GiB allocated")
    mapper = VQAEvalMapper(image_size=ZOO_SIDE)
    rows = []
    for rec in zoo_records():
        m = mapper(rec)
        m["image"] = m.pop("pixel_values")
        rows.append(m)
    fn = zoo.native_blip2_answer_fn(cfg, params, ByteTokenizer(), max_new_tokens=ZOO_NEW,
                                    kind="instructblip")
    spent = dict.fromkeys(("answer", "vision", "prefill"), 0.0)
    outs = []
    original_beam = zoo.blip2_beam_generate

    def keep(*a, **kw):
        out = original_beam(*a, **kw)
        outs.append(out.cpu())
        return out

    zoo.blip2_beam_generate = keep
    restore = _phase_timers({"answer": (zoo, "blip2_beam_generate"),
                             "vision": (b2m, "encode_image"), "prefill": (b2m, "_prefill")},
                            spent, device)
    runs = []
    for i in range(2):   # the second run over the first ZOO_SECOND questions
        pipe = zoo.VLZooVQAPipeline(None, "instructblip", answer_fn=fn)
        spent.update(dict.fromkeys(spent, 0.0))
        outs.clear()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res, counts = counted(wrappers, lambda: pipe.evaluate_model(
            rows if i == 0 else rows[:ZOO_SECOND]))
        torch.cuda.synchronize(device)
        runs.append((res, counts, time.perf_counter() - t0, dict(spent), list(outs),
                     [x["answer"] for x in pipe.evaluator.results],
                     torch.cuda.max_memory_allocated(device) / 2**30))
    restore()
    zoo.blip2_beam_generate = original_beam
    (res, counts, _, _, toks, answers, _), (res2, _, _, _, toks2, answers2, _) = runs
    want = cfg.text.num_hidden_layers * (ZOO_NEW - 1) * ZOO_QUESTIONS
    log(f"launches on the InstructBLIP path: {counts}; K12 predicted {want} "
        f"({cfg.text.num_hidden_layers} layers x {ZOO_NEW - 1} beam steps x {ZOO_QUESTIONS} "
        "questions)")
    if counts["flash_decode"] != want or any(n for k, n in counts.items() if k != "flash_decode"):
        raise RuntimeError(f"InstructBLIP: launches {counts}, K12 predicted {want}")
    if not (res["n"] == ZOO_QUESTIONS and math.isfinite(res["overall"])
            and 0.0 <= res["overall"] <= 100.0):
        raise RuntimeError(f"InstructBLIP: bad metrics {res}")
    if answers[:ZOO_SECOND] != answers2 or res2["n"] != ZOO_SECOND or not all(
            torch.equal(a, b) for a, b in zip(toks, toks2)):
        raise RuntimeError("InstructBLIP: two runs gave different answers")
    log(f"InstructBLIP: {res}; the second run's {ZOO_SECOND} answers identical; answers[:3] "
        f"{answers[:3]}; tokens[0] {toks[0].tolist()}")
    for i, (r, c, wall, t, _, _, peak) in enumerate(runs, 1):
        per_q = 1e3 / r["n"]
        decode = t["answer"] - t["vision"] - t["prefill"]
        log(f"InstructBLIP run {i} ({smi}): {r['n'] / wall:.4f} questions/s "
            f"({wall:.3f} s for {r['n']}); ms per question: vision + Q-Former/projection "
            f"{t['vision'] * per_q:.2f}, Vicuna prefill {t['prefill'] * per_q:.2f}, beam decode "
            f"{decode * per_q:.2f}, the rest (host: tokenizer, pipeline, scoring) "
            f"{(wall - t['answer']) * per_q:.2f}; peak memory {peak:.2f} GiB; K12 launches "
            f"{c['flash_decode']}")
    if profile:
        profile_zoo("instructblip", fn, rows[0])
    run_imagenet_path(cfg, params, device, smi, work)
    del params, fn, pipe
    torch.cuda.empty_cache()
    return counts


IMAGENET_FOLDERS, IMAGENET_PER_FOLDER = 8, 8


def write_imagenet_folders(root):
    """``IMAGENET_FOLDERS`` synset folders of the 1000-synset table (every
    125th), ``IMAGENET_PER_FOLDER`` random 224^2 PNG images each, written by
    the port's PNG writer.  Returns the folder names."""
    import numpy as np

    from cullavo_tpu_torch.data import png_io
    from cullavo_tpu_torch.utils import constants

    rng = np.random.default_rng(SEED + 24)
    folders = constants.IMAGENET_FOLDER_NAMES[::1000 // IMAGENET_FOLDERS][:IMAGENET_FOLDERS]
    for folder in folders:
        os.makedirs(os.path.join(root, folder))
        for j in range(IMAGENET_PER_FOLDER):
            png_io.write_png(os.path.join(root, folder, f"ILSVRC2012_val_{j:08d}.png"),
                             rng.integers(0, 256, (VLP_SIDE, VLP_SIDE, 3), dtype=np.uint8))
    return folders


def run_imagenet_path(cfg, params, device, smi, work):
    """Phase 19b, the zero-shot ImageNet eval over class folders written
    here (8 synsets x 8 PNGs at 224^2): (1) EVA-ViT-g and the text-input
    Q-Former at InstructBLIP's width at ``ZOO_CUT`` layers, f32, card
    against CPU: an image's pooled queries and the 1000 class prompts' text
    states within 1e-4, and top-1 / top-5 / n over 16 of the images equal;
    (2) ``python -m cullavo_tpu_torch eval --conf_files
    configs/vl_test.yaml`` with ``NAME: imagenet_test`` and a ``KIND:
    imagenet`` root in a subprocess (JAX's smoke tower): exit 0, n = 64,
    top-1 / top-5 in [0, 100], the per-class CSV read back, then
    ``entry.evaluate`` on the same config in this process: equal results;
    (3) the full-width tower (``params``) through ``blip2_imagenet_fns``
    over the 1000 ImageNet names and ``ImageNetPipeline`` twice: equal
    top-1 / top-5 / n; images/s, the text-embedding seconds, peak memory."""
    import csv
    import math

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.data.datasets import load_imagenet_folder
    from cullavo_tpu_torch.data.image_processing import preprocess_numpy
    from cullavo_tpu_torch.data.png_io import read_png
    from cullavo_tpu_torch.pipelines.imagenet_pipeline import ImageNetPipeline
    from cullavo_tpu_torch.pipelines.vl_zoo_pipeline import blip2_imagenet_fns
    from cullavo_tpu_torch.utils import constants
    from cullavo_tpu_torch.utils.tree import tree_map

    root = os.path.join(work, "imagenet")
    folders = write_imagenet_folders(root)
    n_images = IMAGENET_FOLDERS * IMAGENET_PER_FOLDER
    side = cfg.vision.image_size
    rows = [{"pixel_values": preprocess_numpy([read_png(x["file_name"])], side)[0],
             "label": x["label"]} for x in load_imagenet_folder(root)]

    r = dataclasses.replace
    cut = r(cfg, vision=r(cfg.vision, num_hidden_layers=ZOO_CUT),
            qformer=r(cfg.qformer, num_hidden_layers=ZOO_CUT))
    small = {"query_tokens": params["query_tokens"],
             "vision": dict(params["vision"], layers={
                 k: a[:ZOO_CUT] for k, a in params["vision"]["layers"].items()}),
             "qformer": dict(params["qformer"], layers=params["qformer"]["layers"][:ZOO_CUT])}
    fns_card = blip2_imagenet_fns(cut, small, constants.IMAGENET_CLASSES)
    cpu = tree_map(lambda t: t.cpu(), small)
    fns_cpu = blip2_imagenet_fns(cut, cpu, constants.IMAGENET_CLASSES)
    pix = torch.from_numpy(rows[0]["pixel_values"][None])
    for what, a, b in (("image embeds", fns_card[0](pix.to(device)), fns_cpu[0](pix)),
                       ("class embeds", fns_card[1], fns_cpu[1])):
        err = (a.cpu() - b).abs().max().item()
        log(f"ImageNet towers at {ZOO_CUT} layers, full width, card vs CPU (f32), {what} "
            f"{tuple(b.shape)}: max_abs_err={err:.3e} (tol 1e-4)")
        if not (torch.isfinite(a).all() and err <= 1e-4):
            raise RuntimeError(f"ImageNet: the card disagrees with the CPU on {what}: {err}")
    scored = [ImageNetPipeline(None, fn, cls, constants.IMAGENET_CLASSES, batch_size=8)
              .evaluate_model(rows[::n_images // 16]) for fn, cls in (fns_card, fns_cpu)]
    log(f"ImageNet at {ZOO_CUT} layers over 16 of the images: card {scored[0]}, CPU {scored[1]}")
    if scored[0] != scored[1]:
        raise RuntimeError(f"ImageNet at cut depth: card {scored[0]} != CPU {scored[1]}")
    del small, cpu, fns_card, fns_cpu

    name = "chip_imagenet_synthetic"
    over = {"NAME": "imagenet_test", "MODEL.ZOO": "instructblip", "BATCH_SIZE": 16,
            "DATASETS.TEST": [name], "DATASETS.REGISTER": {name: {"KIND": "imagenet",
                                                                "ROOT": root}}}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cli_dir = os.path.join(work, "imagenet_cli")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "cullavo_tpu_torch", "eval", "--conf_files",
                          os.path.join(REPO, "configs/vl_test.yaml"), "--config_overrides",
                          json.dumps(over), "--overrides", "SAVE_DIR", cli_dir], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    for line in (res.stdout + res.stderr).strip().splitlines()[-4:]:
        log(f"  imagenet CLI: {line}")
    if res.returncode != 0:
        raise RuntimeError(f"imagenet: python -m cullavo_tpu_torch exited {res.returncode}")
    cli = json.loads(res.stdout.strip().splitlines()[-1])[name]
    with open(os.path.join(cli_dir, "imagenet_per_class.csv"), newline="") as f:
        table = list(csv.reader(f))
    if not (cli["n"] == n_images and all(0 <= cli[k] <= 100 for k in ("top1", "top5"))
            and len(table) == 2 + IMAGENET_FOLDERS and table[-1][0] == "TOTAL"):
        raise RuntimeError(f"imagenet CLI: {cli}, CSV {table}")
    log(f"imagenet CLI ({smi}): exit 0 in {time.perf_counter() - t0:.2f} s; {cli}; CSV "
        f"{len(table) - 2} classes + TOTAL {table[-1]}")
    inproc = entry.evaluate({"NAME": "imagenet_test", "BATCH_SIZE": 16,
                             "MODEL": {"ZOO": "instructblip"}, "DATASETS": {
                                 "TEST": [name], "REGISTER": over["DATASETS.REGISTER"]}})
    if inproc[name] != cli:
        raise RuntimeError(f"imagenet: entry.evaluate {inproc[name]} != the CLI's {cli}")

    t0 = time.perf_counter()
    embed_fn, class_embeds = blip2_imagenet_fns(cfg, params, constants.IMAGENET_CLASSES)
    torch.cuda.synchronize(device)
    t_text = time.perf_counter() - t0
    runs = []
    for _ in range(2):
        pipe = ImageNetPipeline(None, embed_fn, class_embeds, constants.IMAGENET_CLASSES,
                                batch_size=32)
        torch.cuda.reset_peak_memory_stats(device)
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        out = pipe.evaluate_model(rows, out_dir=os.path.join(work, "imagenet_full"))
        torch.cuda.synchronize(device)
        runs.append((out, time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated(device) / 2**30))
    if runs[0][0] != runs[1][0] or runs[0][0]["n"] != n_images or not all(
            math.isfinite(runs[0][0][k]) for k in ("top1", "top5")):
        raise RuntimeError(f"imagenet: {runs[0][0]} vs {runs[1][0]}")
    log(f"ImageNet at full width ({smi}): class embeddings of {len(constants.IMAGENET_CLASSES)} "
        f"names in {t_text:.3f} s; {runs[0][0]} in both runs; folders {folders[:2]}...")
    for i, (out, wall, peak) in enumerate(runs, 1):
        log(f"ImageNet run {i} ({smi}): {n_images / wall:.2f} images/s ({wall:.3f} s for "
            f"{n_images}, batch 32, preprocessed beforehand); peak memory {peak:.2f} GiB")


TOPIC_SECOND = 8              # the second run's questions
TOPIC_QUESTIONS = VL_QUESTION_TEXT + ("What is it?", "Who is there?", "Any dogs?",
                                      "Is it raining?", "What color?", "How many cats?",
                                      "Where is he?", "Is it day?")


def run_topic_path(device, wrappers, smi, profile=False):
    """Phase 19c, the question-topic classifier at the reference's widths:
    a LLaMA-2-7B (vocabulary 32000) in bf16 and CLIP-L/336's text tower (12
    x 768, projection 768) in f32, random on the card, byte tokenizers,
    through ``make_topic_fn`` over COCO's 91 semantic names; the
    ``TOPIC_QUESTIONS`` (16, their prompts in the 256 and 320 buckets)
    twice from one seed: the same classes, K1 32 a question (the prefill)
    and K4 32 a decode forward, nothing else launched; ms per question by
    phase (generate, CLIP), peak memory.  Then ``entry.evaluate`` on vl_test
    with ``MODEL.TOPIC: tiny`` and ``SAVE_DIR`` over 4 questions: the
    per-topic CSV read back.  ``profile``: one more question under
    torch.profiler.  Returns the launches of the first run."""
    import csv

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.data.registry import list_datasets, register_dataset
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.llava.config import LlamaConfig, LlavaConfig
    from cullavo_tpu_torch.models.llava.llama import init_llama_params
    from cullavo_tpu_torch.models.xdecoder.text_encoder import (clip_text_config,
                                                                init_text_encoder_params)
    from cullavo_tpu_torch.pipelines import vqa_pipeline as vq
    from cullavo_tpu_torch.utils import constants

    lcfg = LlavaConfig(text=LlamaConfig(vocab_size=32000))
    ccfg = clip_text_config()
    t0 = time.perf_counter()
    lparams = {"language_model": init_llama_params(
        lcfg.text, torch.Generator(device=device).manual_seed(SEED + 26), device, torch.bfloat16)}
    cparams = init_text_encoder_params(ccfg, torch.Generator(device=device).manual_seed(
        SEED + 27), device)
    torch.cuda.synchronize(device)
    log(f"topic towers (LLaMA-2-7B bf16, CLIP-L/336 text f32) built on the card in "
        f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated(device) / 2**30:.2f} "
        "GiB allocated")
    buckets = sorted({vq._bucket(len(ByteTokenizer().encode(vq.topic_prompt(q))))
                      for q in TOPIC_QUESTIONS})
    spent = dict.fromkeys(("generate", "clip"), 0.0)
    outs = []
    original_generate = vq.generate

    def keep(*a, **kw):
        out = original_generate(*a, **kw)
        outs.append(out[0].cpu())
        return out

    vq.generate = keep
    restore = _phase_timers({"generate": (vq, "generate"), "clip": (vq, "_clip_embed")},
                            spent, device)
    runs = []
    for i in range(2):   # the second run over the first TOPIC_SECOND questions
        fn = vq.make_topic_fn(lparams, lcfg, vq._ByteHFTok(32000), cparams, ccfg,
                              vq._ByteHFTok(ccfg.vocab_size, max_len=77, eot_is_max=True),
                              seed=SEED)
        spent.update(dict.fromkeys(spent, 0.0))
        outs.clear()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        qs = TOPIC_QUESTIONS if i == 0 else TOPIC_QUESTIONS[:TOPIC_SECOND]
        classes, counts = counted(wrappers, lambda: [fn(q) for q in qs])
        torch.cuda.synchronize(device)
        runs.append((classes, counts, time.perf_counter() - t0, dict(spent), list(outs),
                     torch.cuda.max_memory_allocated(device) / 2**30))
    restore()
    vq.generate = original_generate
    classes, counts, _, _, toks, _ = runs[0]
    forwards = [int((t == 2).nonzero()[0]) if (t == 2).any() else len(t) - 1 for t in toks]
    n_layers = lcfg.text.num_hidden_layers
    want = {"flash_fwd": n_layers * len(TOPIC_QUESTIONS), "wwin_decode": n_layers * sum(forwards)}
    log(f"launches on the topic path: {counts}; predicted {want} (prompt buckets {buckets}; "
        f"decode forwards per question {forwards})")
    if any(counts[k] != n for k, n in want.items()) or any(
            n for k, n in counts.items() if k not in want):
        raise RuntimeError(f"topic classifier: launches {counts}, predicted {want}")
    if classes[:TOPIC_SECOND] != runs[1][0] or not all(
            c in constants.COCO_SEMANTIC_CLASSES for c in classes):
        raise RuntimeError(f"topic classifier: {classes} vs {runs[1][0]}")
    log(f"topic classifier: the second run's {TOPIC_SECOND} classes identical: {classes}")
    for i, (cl, c, wall, t, _, peak) in enumerate(runs, 1):
        per_q = 1e3 / len(cl)
        log(f"topic run {i} ({smi}): {wall * per_q:.2f} ms per question (generate "
            f"{t['generate'] * per_q:.2f}, CLIP {t['clip'] * per_q:.2f}, the rest "
            f"{(wall - t['generate'] - t['clip']) * per_q:.2f}); peak memory {peak:.2f} GiB")
    if profile:
        profile_zoo("topic classifier", lambda q, image: fn(q),
                    {"question": TOPIC_QUESTIONS[0], "image": None})
    del lparams, cparams, fn
    torch.cuda.empty_cache()

    if ZOO_DATASET not in list_datasets():
        records = zoo_records()
        register_dataset(ZOO_DATASET, lambda: records, {})
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_topic_") as out_dir:
        res = entry.evaluate({"NAME": "vl_test", "BATCH_SIZE": 4, "MAX_NEW_TOKENS": 8,
                              "LIMIT": 4, "SAVE_DIR": out_dir, "MODEL": {"TOPIC": "tiny"},
                              "DATASETS": {"TEST": [ZOO_DATASET]}})[ZOO_DATASET]
        with open(os.path.join(out_dir, "vqa_per_class.csv"), newline="") as f:
            table = list(csv.reader(f))
    n_topics = sum(int(row[2]) for row in table[1:-1])
    log(f"entry.evaluate vl_test MODEL.TOPIC tiny (card): {res}; vqa_per_class.csv {table}")
    if not (res["n"] == 4 and table[0] == ["class", "accuracy", "n"] and n_topics == 4
            and table[-1][0] == "TOTAL"):
        raise RuntimeError(f"vl_test with MODEL.TOPIC tiny: {res}, {table}")
    return counts


def _bakllava_cut_check(params, cfg, device, wrappers, window, label):
    """BakLLaVA's first ``ZOO_CUT`` layers at full width, bf16, with Mistral's
    ``window``: a text-only prefill of ``BAK_CUT_T`` tokens (one row padded
    by 40) into a cache of ``BAK_CUT_T + 8`` slots, then four greedy decode
    steps, the kernel path on the card against the plain path on the CPU on
    the same weights (the last-token logits within 0.1, as phase 5 holds
    LLaVA's).  Where the window binds (``BAK_CUT_T`` > ``window``) the
    prefill runs the plain attention with the bias, counted in
    ``llama_forward.window_prefills``, and the decode's K4 reads the window
    in its bias; else K1 runs.  Returns (the card's launches, window
    prefills)."""
    import torch

    from cullavo_tpu_torch.models.llava import llama
    from cullavo_tpu_torch.models.llava.modeling import generate_prefill, llava_forward

    params2, cfg2 = cut_layers(params, cfg, ZOO_CUT)
    cfg2 = dataclasses.replace(cfg2, text=dataclasses.replace(cfg2.text, sliding_window=window))

    def to(tree, dev):
        return {k: to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}

    g = torch.Generator().manual_seed(SEED + 31)
    B, T, S, steps = 2, BAK_CUT_T, BAK_CUT_T + 8, 4
    ids = torch.randint(4, 32000, (B, T), generator=g, dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, T - 40:] = 0
    def run_on(dev):
        p = {"language_model": to(params2["language_model"], dev)}

        def run():
            st = generate_prefill(p, cfg2, ids.to(dev), None, mask.to(dev), S)
            got = [st["logits"].float().cpu()]
            tok, cur, idx = st["logits"].argmax(-1).to(torch.int32), st["cur_pos"], T
            for _ in range(steps):
                logits, _ = llava_forward(p, cfg2, tok[:, None], None, None, cur[:, None],
                                          st["cache"], idx, st["full_mask"], st["key_pos"],
                                          stale_cache=True)
                st["full_mask"][:, idx] = 1
                st["key_pos"][:, idx] = cur
                got.append(logits[:, 0].float().cpu())
                tok, cur, idx = logits[:, 0].argmax(-1).to(torch.int32), cur + 1, idx + 1
            return got
        return run

    n0 = llama.llama_forward.window_prefills
    card, counts = counted(wrappers, run_on(device))
    prefills = llama.llama_forward.window_prefills - n0
    cpu = run_on(torch.device("cpu"))()
    worst = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        err = (a - b).abs().max().item()
        worst = max(worst, err)
        if not torch.isfinite(a).all() or a.shape != (B, cfg.text.vocab_size):
            raise RuntimeError(f"{label}: bad logits {tuple(a.shape)}")
        log(f"{label} ({ZOO_CUT} layers, full width, bf16, window {window}, prefill {T}), "
            f"{'prefill' if i == 0 else f'decode step {i}'} logits, card vs CPU: "
            f"max_abs_err={err:.3e}, max |logit| {b.abs().max().item():.3f} (tol 0.1)")
    binds = T > window
    want = {"flash_fwd": 0 if binds else ZOO_CUT, "wwin_decode": ZOO_CUT * steps}
    log(f"{label}: launches {counts} (predicted {want}); window prefills {prefills}")
    if worst > 0.1 or prefills != int(binds) or any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"{label}: err {worst}, launches {counts}, window prefills "
                           f"{prefills}")
    return counts


def write_vqa_files(root, records):
    """A registered-``vqa`` layout of ``records``: q.json, a.json and each
    image as a PNG named COCO_val2014_{image_id:012d}.jpg (the port reads
    PNG bytes whatever the name)."""
    from cullavo_tpu_torch.data import png_io

    os.makedirs(root, exist_ok=True)
    written = set()
    for r in records:
        if r["image_id"] not in written:
            png_io.write_png(os.path.join(root, f"COCO_val2014_{r['image_id']:012d}.jpg"),
                             r["image"])
            written.add(r["image_id"])
    with open(os.path.join(root, "q.json"), "w") as f:
        json.dump({"questions": [{"question_id": r["question_id"], "question": r["question"],
                                  "image_id": r["image_id"]} for r in records]}, f)
    with open(os.path.join(root, "a.json"), "w") as f:
        json.dump({"annotations": [{"question_id": r["question_id"],
                                    "question_type": r["question_type"],
                                    "answer_type": r["answer_type"],
                                    "answers": [{"answer": a} for a in r["answers"]]}
                                   for r in records]}, f)
    return {"KIND": "vqa", "QUESTIONS_JSON": os.path.join(root, "q.json"),
            "ANNOTATIONS_JSON": os.path.join(root, "a.json"), "IMAGE_DIR": root}


def _zoo_path_eval(wrappers, device, cfg):
    """``entry.evaluate(cfg)`` counted, with the snapshot load (the
    answerer's construction) and the answers timed apart; returns
    (results, launches, load s, eval s, peak GiB, answers)."""
    import torch

    from cullavo_tpu_torch import entry

    loads = []
    originals = {name: getattr(entry, name) for name in (
        "native_blip2_answer_fn", "native_kosmos2_answer_fn", "native_bakllava_answer_fn")}

    def timed(fn):
        def build(*a, **kw):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(device)
            loads.append(time.perf_counter() - t)
            return out
        return build

    for name, fn in originals.items():
        setattr(entry, name, timed(fn))
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    res, counts = counted(wrappers, lambda: entry.evaluate(cfg))
    torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for name, fn in originals.items():
        setattr(entry, name, fn)
    with open(os.path.join(cfg["SAVE_DIR"], "vqa_results.json")) as f:
        answers = [a["answer"] for a in json.load(f)]
    return (res, counts, sum(loads), wall - sum(loads),
            torch.cuda.max_memory_allocated(device) / 2**30, answers)


def run_bakllava_path(device, wrappers, smi, work):
    """Phase 20a, BakLLaVA-1 (llava-hf/bakLlava-v1-hf: CLIP-L/336 and
    Mistral-7B, 32 heads over 8 kv heads, sliding window 4096) at full
    width and depth in bf16, random from a seed on the card: the cut-depth
    card-vs-CPU check at Mistral's window (4096: K1 in the prefill) and at a
    window of 256 (it binds in the prefill and in the decode:
    ``_bakllava_cut_check``); the snapshot written in the llava-hf layout
    (``write_snapshot``: Mistral's config.json with ``sliding_window``, the
    BPE tokenizer filled to 32000 pieces with <image> at 32000) and read
    back bit for bit; then
    ``python -m cullavo_tpu_torch eval --conf_files configs/vl_test.yaml``
    with ``MODEL.ZOO: bakllava`` and ``MODEL.ZOO_PATH`` in a subprocess over
    the first ``BAK_CLI_QUESTIONS`` of ``VL_QUESTIONS`` questions written as
    a ``vqa`` dataset (exit 0), and the first ``BAK_QUESTIONS`` through
    ``entry.evaluate`` here,
    counted: the CLI's answers equal, K1 32 a question and K4 32 a decode
    forward; load s, questions/s, peak memory.  Returns the in-process run's
    launches."""
    import math

    import torch

    from cullavo_tpu_torch.checkpoint.hf_import import load_llava_safetensors
    from cullavo_tpu_torch.models.llava.config import bakllava_config
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params

    cfg = bakllava_config()
    t0 = time.perf_counter()
    params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(SEED + 30),
                               device, dtype=torch.bfloat16)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for _, t in _tree_leaves(params))
    log(f"bakLlava-v1: {n_params / 1e9:.3f} G parameters in bf16 built on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    for window in (cfg.text.sliding_window, BAK_CUT_WINDOW):
        _bakllava_cut_check(params, cfg, device, wrappers, window,
                            f"BakLLaVA cut check (window {window})")
    snap = os.path.join(work, "bakllava")
    os.makedirs(snap)
    t0 = time.perf_counter()
    total = write_snapshot(params, cfg, snap)
    t_write = time.perf_counter() - t0
    loaded = load_llava_safetensors(snap, cfg, device=device)
    want, got = dict(_tree_leaves(params)), dict(_tree_leaves(loaded))
    bad = [k for k, a in want.items() if k not in got or not torch.equal(
        a.view(torch.int16), got[k].view(torch.int16))]
    log(f"BakLLaVA snapshot: {total / 1e9:.3f} GB of bf16 weights written in {t_write:.2f} s; "
        f"{len(got)} tensors read back, mismatching {len(bad)} (bit-equal demanded)")
    if bad or len(want) != len(got):
        raise RuntimeError(f"the BakLLaVA snapshot differs from the written weights: {bad[:5]}")
    del params, loaded, want, got
    torch.cuda.empty_cache()

    name = "chip_vqa_files"
    spec = write_vqa_files(os.path.join(work, "vqa_files"), vqa_records())
    over = {"MODEL.ZOO": "bakllava", "MODEL.ZOO_PATH": snap, "DATASETS.TEST": [name],
            "DATASETS.REGISTER": {name: spec}, "LIMIT": BAK_CLI_QUESTIONS}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    cli_dir = os.path.join(work, "bakllava_cli")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "cullavo_tpu_torch", "eval", "--conf_files",
                          os.path.join(REPO, "configs/vl_test.yaml"), "--config_overrides",
                          json.dumps(over), "--overrides", "SAVE_DIR", cli_dir], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    for line in (res.stdout + res.stderr).strip().splitlines()[-4:]:
        log(f"  BakLLaVA CLI: {line}")
    if res.returncode != 0:
        raise RuntimeError(f"BakLLaVA: python -m cullavo_tpu_torch exited {res.returncode}")
    cli = json.loads(res.stdout.strip().splitlines()[-1])[name]
    with open(os.path.join(cli_dir, "vqa_results.json")) as f:
        cli_answers = [a["answer"] for a in json.load(f)]
    log(f"BakLLaVA CLI ({smi}): {cli} in {t_cli:.2f} s (the process, the snapshot load and "
        f"{BAK_CLI_QUESTIONS} answers)")
    vl = {"NAME": "vl_test", "MAX_NEW_TOKENS": 16, "LIMIT": BAK_QUESTIONS,
          "SAVE_DIR": os.path.join(work, "bakllava_out"),
          "MODEL": {"ZOO": "bakllava", "ZOO_PATH": snap},
          "DATASETS": {"TEST": [name], "REGISTER": {name: spec}}}
    res, counts, t_load, t_eval, peak, answers = _zoo_path_eval(wrappers, device, vl)
    res = res[name]
    n_layers = cfg.text.num_hidden_layers
    log(f"launches on the BakLLaVA path: {counts}")
    if not (answers[:BAK_CLI_QUESTIONS] == cli_answers and cli["n"] == BAK_CLI_QUESTIONS
            and res["n"] == BAK_QUESTIONS and math.isfinite(res["overall"])
            and 0.0 <= res["overall"] <= 100.0):
        raise RuntimeError(f"BakLLaVA: in process {res} vs the CLI's {cli}")
    if (counts["flash_fwd"] != n_layers * BAK_QUESTIONS or counts["wwin_decode"] == 0
            or counts["wwin_decode"] % n_layers
            or any(n for k, n in counts.items() if k not in ("flash_fwd", "wwin_decode"))):
        raise RuntimeError(f"BakLLaVA: launches {counts}")
    log(f"BakLLaVA: {res}; the CLI's {BAK_CLI_QUESTIONS} answers equal; answers[:4] "
        f"{answers[:4]}")
    log(f"BakLLaVA ({smi}): snapshot load {t_load:.3f} s, {BAK_QUESTIONS / t_eval:.4f} "
        f"questions/s ({t_eval:.3f} s for {BAK_QUESTIONS}, {counts['wwin_decode'] // n_layers} "
        f"decode forwards), peak memory {peak:.2f} GiB")
    shutil.rmtree(snap)
    torch.cuda.empty_cache()
    return counts


def _blip2_hf_config(cfg, kind):
    """The config.json fields the port holds a BLIP-2 snapshot to."""
    v, q, t = cfg.vision, cfg.qformer, cfg.text
    vision = {k: getattr(v, k) for k in ("hidden_size", "intermediate_size", "num_hidden_layers",
                                         "num_attention_heads", "image_size", "patch_size")}
    qformer = {k: getattr(q, k) for k in ("hidden_size", "num_hidden_layers",
                                          "num_attention_heads", "intermediate_size",
                                          "cross_attention_frequency", "encoder_hidden_size",
                                          "vocab_size")}
    if cfg.text_is_t5:
        text = {"model_type": "t5", **{k: getattr(t, k) for k in (
            "vocab_size", "d_model", "d_kv", "num_heads", "d_ff", "num_layers",
            "num_decoder_layers", "relative_attention_num_buckets",
            "relative_attention_max_distance")}}
    elif cfg.text_is_opt:
        text = {"model_type": "opt", "word_embed_proj_dim": t.hidden_size, **{
            k: getattr(t, k) for k in ("vocab_size", "hidden_size", "ffn_dim",
                                       "num_hidden_layers", "num_attention_heads",
                                       "max_position_embeddings", "do_layer_norm_before",
                                       "activation_function")}}
    else:
        text = {"model_type": "llama", **{k: getattr(t, k) for k in (
            "vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
            "num_attention_heads", "num_key_value_heads")}}
    blip2 = kind in ("flant5", "opt")
    arch = "Blip2ForConditionalGeneration" if blip2 else "InstructBlipForConditionalGeneration"
    return {"architectures": [arch], "model_type": "blip-2" if blip2 else "instructblip",
            "num_query_tokens": cfg.num_query_tokens, "vision_config": vision,
            "qformer_config": qformer, "text_config": text}


def write_zoo_snapshot(path, kind, cfg, params):
    """A snapshot of ``kind`` ("flant5", "opt", "instructblip", "kosmos2")
    in the HF layout from the port's tree: config.json, model.safetensors
    (f32, by ``zoo_import``'s exporters and the port's writer), the
    synthetic tokenizers of the published sizes (Flan-T5: Unigram 32128
    with 100 <extra_id_N>; OPT: GPT-2's byte-level BPE of 50265 ids;
    InstructBLIP: Vicuna's BPE of 32000 pieces with <pad> at 32000, and
    under qformer_tokenizer/ BERT's WordPiece 30522 + [DEC]; KOSMOS-2:
    XLM-R's Unigram 65037 with its tags and 1024 patch tokens) and, for
    KOSMOS-2, the image processor's config.  Returns the bytes of
    weights."""
    from cullavo_tpu_torch.checkpoint.safetensors_io import write_safetensors
    from cullavo_tpu_torch.checkpoint.zoo_import import (blip2_to_hf_state_dict,
                                                         kosmos2_to_hf_state_dict)
    from cullavo_tpu_torch.data.image_processing import CLIP_MEAN, CLIP_STD

    os.makedirs(path)
    if kind == "kosmos2":
        v, t = cfg.vision, cfg.text
        hf = {"architectures": ["Kosmos2ForConditionalGeneration"], "model_type": "kosmos-2",
              "latent_query_num": cfg.latent_query_num,
              "vision_config": {k: getattr(v, k) for k in (
                  "hidden_size", "intermediate_size", "num_hidden_layers",
                  "num_attention_heads", "image_size", "patch_size")},
              "text_config": {k: getattr(t, k) for k in (
                  "vocab_size", "embed_dim", "layers", "ffn_dim", "attention_heads")}}
        state = kosmos2_to_hf_state_dict(params, cfg)
        write_unigram_tokenizer(path, "xlmr", t.vocab_size, n_patch=1024, seed=SEED + 41)
        with open(os.path.join(path, "processor_config.json"), "w") as f:
            json.dump({"processor_class": "Kosmos2Processor", "num_patch_index_tokens": 1024}, f)
        side = v.image_size
        image = {"image_processor_type": "CLIPImageProcessor", "do_resize": True,
                 "size": {"shortest_edge": side}, "resample": 3, "do_center_crop": True,
                 "crop_size": {"height": side, "width": side}, "do_rescale": True,
                 "rescale_factor": 1 / 255, "do_normalize": True, "image_mean": list(CLIP_MEAN),
                 "image_std": list(CLIP_STD), "do_convert_rgb": True}
        with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
            json.dump(image, f)
    else:
        hf = _blip2_hf_config(cfg, kind)
        state = blip2_to_hf_state_dict(params, cfg)
        if kind == "flant5":
            write_unigram_tokenizer(path, "t5", cfg.text.vocab_size, n_extra=100, seed=SEED + 42)
        elif kind == "opt":
            write_bytelevel_tokenizer(path, OPT_TOKENIZER_IDS)
        else:
            write_tokenizer(path, added=((32000, "<pad>"),), n_vocab=32000)
            write_wordpiece_tokenizer(os.path.join(path, "qformer_tokenizer"), 30522,
                                      seed=SEED + 43)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf, f, indent=1)
    write_safetensors(state, os.path.join(path, "model.safetensors"), {"format": "pt"})
    return nbytes(*state.values())


def run_zoo_snapshot_path(device, wrappers, smi, work):
    """Phase 20b, the VL zoo from local snapshots at full width (f32, as the
    pipeline's ModelSpec loads them), depth cut to ``ZOO_PATH_CUT``:
    Salesforce/blip2-flan-t5-xl, Salesforce/instructblip-vicuna-7b (its
    Q-Former table 30523 rows, [DEC] included) and
    microsoft/kosmos-2-patch14-224, random on the card, each written by
    ``write_zoo_snapshot`` and read through ``entry.evaluate`` with
    ``MODEL.ZOO_PATH`` (the published config factories swapped for the cut
    ones while it runs) over phase 11's ``ZOO_QUESTIONS`` questions (beam 5
    / greedy, ``ZOO_NEW`` tokens): n = 8, a finite accuracy, K12 launched
    and nothing else; then ``imagenet_test`` from the InstructBLIP snapshot
    over phase 19b's class folders.  Load s, questions/s, peak memory; each
    snapshot deleted after its run.  Returns the summed launches."""
    import math

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.data.registry import list_datasets, register_dataset
    from cullavo_tpu_torch.models import kosmos2 as k2
    from cullavo_tpu_torch.models.blip2 import (blip2_flant5xl_config, init_blip2_params,
                                                instructblip_vicuna7b_config)
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo
    from cullavo_tpu_torch.utils import constants

    if ZOO_DATASET not in list_datasets():
        records = zoo_records()
        register_dataset(ZOO_DATASET, lambda: records, {})
    r = dataclasses.replace
    cut = ZOO_PATH_CUT
    b2 = blip2_flant5xl_config()
    ib = instructblip_vicuna7b_config()
    kc = k2.Kosmos2Config()
    cfgs = {
        "flant5": r(b2, vision=r(b2.vision, num_hidden_layers=cut["vision"]),
                    qformer=r(b2.qformer, num_hidden_layers=cut["qformer"]),
                    text=r(b2.text, num_layers=cut["text"], num_decoder_layers=cut["text"])),
        "instructblip": r(ib, vision=r(ib.vision, num_hidden_layers=cut["vision"]),
                          qformer=r(ib.qformer, num_hidden_layers=cut["qformer"],
                                    vocab_size=30523),
                          text=r(ib.text, num_hidden_layers=cut["text"])),
        "kosmos2": r(kc, vision=r(kc.vision, num_hidden_layers=cut["vision"]),
                     text=r(kc.text, layers=cut["text"]))}
    saved = zoo._blip2_cfg_cls, zoo.Kosmos2Config
    zoo._blip2_cfg_cls = lambda kind: (cfgs[kind], None)
    zoo.Kosmos2Config = lambda: cfgs["kosmos2"]
    total = collections.Counter()
    for kind, zoo_name in (("flant5", "blip2"), ("instructblip", "instructblip"),
                           ("kosmos2", "kosmos2")):
        cfg = cfgs[kind]
        gen = torch.Generator(device=device).manual_seed(SEED + 44)
        t0 = time.perf_counter()
        params = (k2.init_kosmos2_params(cfg, gen, device) if kind == "kosmos2"
                  else init_blip2_params(cfg, gen, device))
        snap = os.path.join(work, f"zoo_{kind}")
        nb = write_zoo_snapshot(snap, kind, cfg, params)
        t_write = time.perf_counter() - t0
        del params
        torch.cuda.empty_cache()
        vl = {"NAME": "vl_test", "MAX_NEW_TOKENS": ZOO_NEW, "LIMIT": 0,
              "SAVE_DIR": os.path.join(work, f"zoo_{kind}_out"),
              "MODEL": {"ZOO": zoo_name, "ZOO_PATH": snap}, "DATASETS": {"TEST": [ZOO_DATASET]}}
        res, counts, t_load, t_eval, peak, answers = _zoo_path_eval(wrappers, device, vl)
        res = res[ZOO_DATASET]
        log(f"zoo snapshot {kind} ({cut} layers, full width, f32): {nb / 1e9:.3f} GB built and "
            f"written in {t_write:.2f} s; launches {counts}; {res}; answers[:3] {answers[:3]}")
        if not (res["n"] == ZOO_QUESTIONS and math.isfinite(res["overall"])
                and 0.0 <= res["overall"] <= 100.0 and counts["flash_decode"] > 0
                and not any(n for k, n in counts.items() if k != "flash_decode")):
            raise RuntimeError(f"zoo snapshot {kind}: {res}, launches {counts}")
        log(f"zoo snapshot {kind} ({smi}): snapshot load {t_load:.3f} s, "
            f"{ZOO_QUESTIONS / t_eval:.4f} questions/s ({t_eval:.3f} s for {ZOO_QUESTIONS}), "
            f"peak memory {peak:.2f} GiB")
        total.update(counts)
        if kind == "instructblip":
            root = os.path.join(work, "imagenet_zoo_path")
            folders = write_imagenet_folders(root)
            name = "chip_imagenet_zoo_path"
            index = {f: i for i, f in enumerate(constants.IMAGENET_FOLDER_NAMES)}
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            out = entry.evaluate({
                "NAME": "imagenet_test", "LIMIT": 0, "BATCH_SIZE": 16,
                "SAVE_DIR": os.path.join(work, "imagenet_zoo_path_out"),
                "MODEL": {"ZOO": "instructblip", "ZOO_PATH": snap},
                "DATASETS": {"TEST": [name], "REGISTER": {name: {
                    "KIND": "imagenet", "ROOT": root, "FOLDERS": folders,
                    "CLASS_NAMES": [constants.IMAGENET_CLASSES[index[f]] for f in folders]}}}})
            wall = time.perf_counter() - t0
            got = out[name]
            log(f"imagenet_test from the InstructBLIP snapshot ({smi}): {got} in {wall:.3f} s "
                f"(the load, {len(folders)} class prompts, "
                f"{IMAGENET_FOLDERS * IMAGENET_PER_FOLDER} images), peak memory "
                f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
            if not (got["n"] == IMAGENET_FOLDERS * IMAGENET_PER_FOLDER
                    and all(0.0 <= got[k] <= 100.0 for k in ("top1", "top5"))):
                raise RuntimeError(f"imagenet_test from the snapshot: {got}")
            shutil.rmtree(root)
        shutil.rmtree(snap)
        torch.cuda.empty_cache()
    zoo._blip2_cfg_cls, zoo.Kosmos2Config = saved
    return dict(total)


def _opt_probe(cfg, params, inputs):
    """BLIP-2 OPT's forward logits, and the logits of the prefill's last
    position and of decode steps over the head-major cache (K12 on the card
    in f32), on one device."""
    import torch

    from cullavo_tpu_torch.models.blip2 import modeling as b2m

    pix, ids, dec = inputs
    mask = torch.ones_like(ids)
    logits = b2m.blip2_forward(params, cfg, pix, ids, mask)
    embeds, mask0 = b2m._prefix_inputs(params, b2m.encode_image(params, cfg, pix), ids, mask)
    cache, full_mask, key_pos, first, last_pos = b2m._prefill(params, cfg, embeds, mask0,
                                                             dec.shape[1] + 1)
    steps, T = [first], mask0.shape[1]
    for i in range(dec.shape[1]):
        last_pos = last_pos + 1
        steps.append(b2m._step(params, cfg, dec[:, i], cache, full_mask, key_pos, T + i,
                               last_pos, embeds.dtype))
    return logits, torch.stack(steps, 1)


def _opt_cut(cfg, vision, qformer, text):
    r = dataclasses.replace
    return r(cfg, vision=r(cfg.vision, num_hidden_layers=vision),
             qformer=r(cfg.qformer, num_hidden_layers=qformer),
             text=r(cfg.text, num_hidden_layers=text))


def run_opt_path(device, wrappers, smi, work, profile=False):
    """Phase 21, BLIP-2 OPT (Salesforce/blip2-opt-2.7b: EVA-ViT-g 39 x 1408,
    the Q-Former 12 x 768, OPT 32 x 2560 with 32 heads of 80), f32.  21a: a
    card-vs-CPU check at ``ZOO_CUT`` layers per tower (forward logits, the
    prefill's last logits and four decode steps: K12 ``ZOO_CUT`` x 4), then
    the full width and depth with seeded random weights built on the card
    answering ``ZOO_QUESTIONS`` questions through ``VLZooVQAPipeline`` with
    the checkpoint-free native answerer (``kind="opt"``: beam 5, length
    penalty -1, ``ZOO_NEW`` tokens, the byte tokenizer), then the first
    ``ZOO_SECOND`` again: n = 8, a finite accuracy, identical answers and
    tokens, K12 launched 32 layers x 9 beam steps x 8 and nothing else;
    questions/s, ms per question by phase, peak memory.  21b: a
    blip2-opt-2.7b-shaped snapshot at ``ZOO_PATH_CUT`` depth (full width,
    the byte-level BPE tokenizer of 50265 ids) written by
    ``write_zoo_snapshot``, read back bit-equal by ``load_blip2_safetensors``,
    then ``native_blip2_answer_fn(hf_model_dir=..., kind="opt")`` (the
    published config factory swapped for the cut one) answering phase 11's
    ``ZOO_QUESTIONS`` raw images through the pipeline: n = 8, a finite
    accuracy, K12 launched cut layers x 9 x 8.  Returns the launches of
    21a's first run and of 21b."""
    import math

    import torch

    from cullavo_tpu_torch.checkpoint.zoo_import import load_blip2_safetensors
    from cullavo_tpu_torch.data.mappers.eval_mappers import VQAEvalMapper
    from cullavo_tpu_torch.data.tokenizer import ByteTokenizer
    from cullavo_tpu_torch.models.blip2 import Blip2Config, init_blip2_params
    from cullavo_tpu_torch.models.blip2 import modeling as b2m
    from cullavo_tpu_torch.pipelines import vl_zoo_pipeline as zoo
    from cullavo_tpu_torch.utils.tree import tree_leaves

    cfg = Blip2Config()
    cut = _opt_cut(cfg, ZOO_CUT, ZOO_CUT, ZOO_CUT)
    params = init_blip2_params(cut, torch.Generator(device=device).manual_seed(SEED + 51), device)
    text = zoo.MODEL_SPECS["blip2"].prompt.format(q=VL_QUESTION_TEXT[0])
    ids = torch.tensor([ByteTokenizer().encode(text)], device=device)
    g = torch.Generator(device=device).manual_seed(SEED + 52)
    inputs = (torch.randn((1, 3, ZOO_SIDE, ZOO_SIDE), generator=g, device=device), ids,
              torch.randint(4, 260, (1, 4), generator=g, device=device))
    _cut_depth_check("BLIP-2 OPT", _opt_probe, cut, params, inputs, device, wrappers,
                     {"flash_decode": ZOO_CUT * 4})
    del params
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    params = init_blip2_params(cfg, torch.Generator(device=device).manual_seed(SEED + 53), device)
    torch.cuda.synchronize(device)
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"blip2-opt-2.7b: {n_params / 1e9:.3f} G parameters in f32 built on the card in "
        f"{time.perf_counter() - t0:.3f} s, {torch.cuda.memory_allocated(device) / 2**30:.2f} "
        "GiB allocated")
    mapper = VQAEvalMapper(image_size=ZOO_SIDE)
    rows = []
    for rec in zoo_records():
        m = mapper(rec)
        m["image"] = m.pop("pixel_values")
        rows.append(m)
    fn = zoo.native_blip2_answer_fn(cfg, params, ByteTokenizer(), max_new_tokens=ZOO_NEW,
                                    kind="opt")
    spent = dict.fromkeys(("answer", "vision", "prefill"), 0.0)
    outs = []
    original_beam = zoo.blip2_beam_generate

    def keep(*a, **kw):
        out = original_beam(*a, **kw)
        outs.append(out.cpu())
        return out

    zoo.blip2_beam_generate = keep
    restore = _phase_timers({"answer": (zoo, "blip2_beam_generate"),
                             "vision": (b2m, "encode_image"), "prefill": (b2m, "_prefill")},
                            spent, device)
    runs = []
    for i in range(2):   # the second run over the first ZOO_SECOND questions
        pipe = zoo.VLZooVQAPipeline(None, "blip2", answer_fn=fn)
        spent.update(dict.fromkeys(spent, 0.0))
        outs.clear()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        res, counts = counted(wrappers, lambda: pipe.evaluate_model(
            rows if i == 0 else rows[:ZOO_SECOND]))
        torch.cuda.synchronize(device)
        runs.append((res, counts, time.perf_counter() - t0, dict(spent), list(outs),
                     [x["answer"] for x in pipe.evaluator.results],
                     torch.cuda.max_memory_allocated(device) / 2**30))
    restore()
    zoo.blip2_beam_generate = original_beam
    (res, counts, _, _, toks, answers, _), (res2, counts2, _, _, toks2, answers2, _) = runs
    L = cfg.text.num_hidden_layers
    want = L * (ZOO_NEW - 1) * ZOO_QUESTIONS
    log(f"launches on the BLIP-2 OPT path: {counts}; K12 predicted {want} ({L} layers x "
        f"{ZOO_NEW - 1} beam steps x {ZOO_QUESTIONS} questions)")
    if (counts["flash_decode"] != want
            or counts2["flash_decode"] != L * (ZOO_NEW - 1) * ZOO_SECOND
            or any(n for k, n in counts.items() if k != "flash_decode")):
        raise RuntimeError(f"BLIP-2 OPT: launches {counts} / {counts2}, K12 predicted {want}")
    if not (res["n"] == ZOO_QUESTIONS and math.isfinite(res["overall"])
            and 0.0 <= res["overall"] <= 100.0):
        raise RuntimeError(f"BLIP-2 OPT: bad metrics {res}")
    if answers[:ZOO_SECOND] != answers2 or res2["n"] != ZOO_SECOND or not all(
            torch.equal(a, b) for a, b in zip(toks, toks2)):
        raise RuntimeError("BLIP-2 OPT: two runs gave different answers")
    log(f"BLIP-2 OPT: {res}; the second run's {ZOO_SECOND} answers identical; answers[:3] "
        f"{answers[:3]}; tokens[0] {toks[0].tolist()}")
    for i, (r, c, wall, t, _, _, peak) in enumerate(runs, 1):
        per_q = 1e3 / r["n"]
        decode = t["answer"] - t["vision"] - t["prefill"]
        log(f"BLIP-2 OPT run {i} ({smi}): {r['n'] / wall:.4f} questions/s ({wall:.3f} s for "
            f"{r['n']}); ms per question: vision + Q-Former/projection "
            f"{t['vision'] * per_q:.2f}, OPT prefill {t['prefill'] * per_q:.2f}, beam decode "
            f"{decode * per_q:.2f}, the rest (host: tokenizer, pipeline, scoring) "
            f"{(wall - t['answer']) * per_q:.2f}; peak memory {peak:.2f} GiB; K12 launches "
            f"{c['flash_decode']}")
    if profile:
        profile_zoo("blip2-opt", fn, rows[0])
    del params, fn, pipe
    torch.cuda.empty_cache()

    # 21b: a snapshot at cut depth through the snapshot answerer
    c = ZOO_PATH_CUT
    snap_cfg = _opt_cut(cfg, c["vision"], c["qformer"], c["text"])
    t0 = time.perf_counter()
    params = init_blip2_params(snap_cfg, torch.Generator(device=device).manual_seed(SEED + 54),
                               device)
    snap = os.path.join(work, "zoo_opt")
    nb = write_zoo_snapshot(snap, "opt", snap_cfg, params)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = load_blip2_safetensors(snap, snap_cfg, dtype=torch.float32, device=device)
    t_read = time.perf_counter() - t0
    bad = _same_tree(back, params)
    log(f"blip2-opt snapshot ({c} layers, full width, f32): {nb / 1e9:.3f} GB built and written "
        f"in {t_write:.2f} s, read back in {t_read:.2f} s: {len(bad)} leaves differ "
        "(bit-equal demanded)")
    if bad:
        raise RuntimeError(f"the blip2-opt snapshot differs from the written weights: {bad[:5]}")
    del params, back
    torch.cuda.empty_cache()
    saved = zoo._blip2_cfg_cls
    zoo._blip2_cfg_cls = lambda kind: (snap_cfg, None)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    fn = zoo.native_blip2_answer_fn(hf_model_dir=snap, kind="opt", max_new_tokens=ZOO_NEW)
    torch.cuda.synchronize(device)
    t_load = time.perf_counter() - t0
    pipe = zoo.VLZooVQAPipeline(None, "blip2", answer_fn=fn)
    t0 = time.perf_counter()
    res, counts = counted(wrappers, lambda: pipe.evaluate_model(zoo_records()))
    torch.cuda.synchronize(device)
    t_eval = time.perf_counter() - t0
    zoo._blip2_cfg_cls = saved
    answers = [x["answer"] for x in pipe.evaluator.results]
    want = c["text"] * (ZOO_NEW - 1) * ZOO_QUESTIONS
    log(f"blip2-opt snapshot through native_blip2_answer_fn(hf_model_dir, kind='opt'): {res}; "
        f"launches {counts} (K12 predicted {want}); answers[:3] {answers[:3]}")
    if not (res["n"] == ZOO_QUESTIONS and math.isfinite(res["overall"])
            and 0.0 <= res["overall"] <= 100.0 and counts["flash_decode"] == want
            and not any(n for k, n in counts.items() if k != "flash_decode")):
        raise RuntimeError(f"blip2-opt snapshot: {res}, launches {counts}")
    log(f"blip2-opt snapshot ({smi}): snapshot load (tokenizer, config, weights) "
        f"{t_load:.3f} s, {ZOO_QUESTIONS / t_eval:.4f} questions/s ({t_eval:.3f} s for "
        f"{ZOO_QUESTIONS}, raw images CLIP-preprocessed by the answerer), peak memory "
        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
    shutil.rmtree(snap)
    del fn, pipe
    torch.cuda.empty_cache()
    return runs[0][1], counts


def check_packed_kernel(device, g):
    """Phase 3, K13 (the packed-heads causal forward, Pallas rows 3 and 4:
    K1's kernel behind maps its entry encodes) against its plain version
    (the heads as views + ``mha_reference``) at the prefill shape [7, 648,
    32*128], the train shape [8, 1024, 32*128], a ragged T and S > T: o
    within 1e-2 + 1e-2 |ref| of the plain version run on the inputs widened
    to f64, so without its own bf16 rounding of P and O (the bf16 plain
    version's error is printed beside it: at a query row of a few keys whose
    values cancel, its rounding of the normalised P alone takes ~0.7 of
    that bound, and the two roundings together can pass it), and where S ==
    T ``torch.equal`` to K1 on the head views of the same bytes; the autograd function's dq, dk, dv within
    2e-2 of the largest entry against autograd through the plain version;
    timed at both shapes in turns with K1 on those head views and
    ``scaled_dot_product_attention(is_causal=True)`` on them (a yardstick
    the port never calls), the card kept busy ahead of each timed call
    (each call's host time measured apart), beside the bound and the plain
    version."""
    import torch

    from cullavo_tpu_torch.ops import flash_attention as fa

    bf, H, d = torch.bfloat16, 32, 128
    T_pre = PAD_TO * -(-(1 + 576 + PROMPT_TEXT) // PAD_TO)
    rec = {}

    def qkv(B, T, S):
        return (torch.randn((B, T, H * d), generator=g, device=device).to(bf),
                *(torch.randn((B, S, H * d), generator=g, device=device).to(bf)
                  for _ in range(2)))

    for label, B, T, S in (("train", TRAIN_CFG["BATCH_SIZE"], TRAIN_T, TRAIN_T),
                           ("prefill", CHUNK, T_pre, T_pre),
                           ("ragged T, S > T", 3, 601, 648), ("ragged T = S", 2, 37, 37)):
        q, k, v = qkv(B, T, S)
        out = fa.flash_attention_packed(q, k, v, H)
        ref = fa._packed_plain(q.double(), k.double(), v.double(), H).float()
        plain_bf16 = fa._packed_plain(q, k, v, H).float()
        views = [fa._packed_to_heads(t, H) for t in (q, k, v)]
        torch.cuda.synchronize(device)
        err = (out.float() - ref).abs().max().item()
        same = S == T and torch.equal(out, fa._heads_to_packed(fa.flash_attention(*views)))
        log(f"K13 flash_packed {label} [{B}, {T}, {H}*{d}] S={S}: max_abs_err={err:.3e} "
            f"(tol 1e-2 + 1e-2 |ref|: bf16 rounding of P and O; ref: the plain version on f64 "
            f"inputs, no bf16 rounding); "
            f"the bf16 plain version from it {(plain_bf16 - ref).abs().max().item():.3e}, from "
            f"the kernel {(out.float() - plain_bf16).abs().max().item():.3e}"
            + (f"; equal to K1 on the head views: {same}" if S == T else ""))
        if not torch.allclose(out.float(), ref, rtol=1e-2, atol=1e-2):
            raise RuntimeError(f"K13 disagrees with its plain version ({label}): {err}")
        if S == T and not same:
            raise RuntimeError(f"K13 ({label}) is not bit-equal to K1 on the same bytes")
        if label in ("prefill", "train"):
            fns = {"kernel": lambda: fa.flash_attention_packed(q, k, v, H),
                   "library": lambda: torch.nn.functional.scaled_dot_product_attention(
                       *views, is_causal=True),
                   "k1": lambda: fa.flash_attention(*views)}
            t = bench_turns(fns, device, rounds=3, lead_cycles=1_000_000)
            host = {n: host_us(fn, device) for n, fn in fns.items()}
            plain = bench_ms(lambda: fa._packed_plain(q, k, v, H), device, reps=5)
            ms, lib, k1 = (statistics.median(t[n]) for n in ("kernel", "library", "k1"))
            # visible pairs: query i sees keys 0..i
            bd = bound(nbytes(q, k, v, out), 4 * B * H * d * T * (T + 1) / 2, "bf16")
            spread = {n: [round(x, 4) for x in v_] for n, v_ in t.items()}
            log(f"K13 {label} B={B} T={T}: kernel {ms:.4f} ms, plain {plain:.4f} ms, library "
                f"sdpa on the head views {lib:.4f} ms, K1 on the same bytes {k1:.4f} ms (K13 / K1 "
                f"{ms / k1:.3f}), bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}); in turns "
                f"{spread}; host us per call {({n: round(x, 1) for n, x in host.items()})}")
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, k1_same_inputs_ms=k1, **bd,
                       times_in_turns=spread, host_us=host)
            if label == "train":
                rec["flash_packed"] = dict(
                    max_abs_err=err, **row,
                    shape=f"q/k/v [{B},{T},{H}*{d}] bf16 causal (prefill [{CHUNK},{T_pre},"
                          f"{H}*{d}]: prefill_shape)")
            else:
                rec["flash_packed"]["prefill_shape"] = dict(T=T, B=B, max_abs_err=err, **row)
            del fns
        del q, k, v, out, ref, plain_bf16, views
    # gradients through the autograd function: K13 forward, then the
    # standard K1-lse (S == T) or K8 (S > T) forward and the chunked backward
    for T, S in ((TRAIN_T, TRAIN_T), (301, 512)):
        q, k, v = qkv(TRAIN_CFG["BATCH_SIZE"] if S == T else 2, T, S)
        do = torch.randn(q.shape, generator=g, device=device).to(bf)
        grads = []
        for fn in (fa.flash_attention_packed, fa._packed_plain):
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            grads.append(torch.autograd.grad(fn(*leaves, H), leaves, do))
        torch.cuda.synchronize(device)
        for name, a, b in zip(("dq", "dk", "dv"), *grads):
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            log(f"K13 autograd T={T} S={S} {name}: max_abs_err={err:.3e}, max |ref| {top:.3f} "
                "(tol 2e-2 of the largest entry: P, dS and dO round to bf16)")
            if not (torch.isfinite(a).all() and err <= 2e-2 * top):
                raise RuntimeError(f"K13 autograd: {name} disagrees at T={T} S={S}: {err}")
        del q, k, v, do, grads
    torch.cuda.empty_cache()
    return rec


def check_p32_kernel(device, g):
    """Phase 3, K14 (the p32 product of the matmul probe, Pallas row 16):
    ``pack_p32`` bit-equal to a numpy re-statement of the JAX script's
    packing; K14 within 1e-2 + 1e-2 |ref| of the f32 plain version at M = 1,
    8 and 64 over [4096, 11008]; timed at M = 8 beside the bound (the
    45.1 MB weight read), the plain version and the dense bf16
    ``torch.matmul`` on the unpacked, scaled weight (the yardstick)."""
    import numpy as np
    import torch

    from cullavo_tpu_torch.scripts import matmul_probe as mp

    K, N = mp.K, mp.N
    w8 = torch.randint(-128, 128, (K, N), generator=g, device=device, dtype=torch.int8)
    w32 = mp.pack_p32(w8)
    kq = K // 4
    b = w8.cpu().numpy().astype(np.int32) & 0xFF
    want = (b[0 * kq:1 * kq] | (b[1 * kq:2 * kq] << 8) | (b[2 * kq:3 * kq] << 16)
            | (b[3 * kq:4 * kq] << 24)).astype(np.int32)
    n_bad = int((w32.cpu().numpy() != want).sum())
    log(f"K14 pack_p32 [{K}, {N}] -> [{kq}, {N}] int32: {n_bad} words differ from the numpy "
        "packing (bit-equal demanded)")
    if n_bad:
        raise RuntimeError("pack_p32 differs from the JAX script's packing")
    scale = torch.rand((N,), generator=g, device=device) * 0.01
    rec, errs = {}, []
    for M in (1, 8, 64):
        x = torch.randn((M, K), generator=g, device=device).to(torch.bfloat16)
        y = mp.p32_linear(x, w32, scale)
        ref = mp.p32_linear_plain(x, w32, scale)
        torch.cuda.synchronize(device)
        if not torch.equal(y, mp.p32_linear(x, w32, scale)):
            raise RuntimeError(f"K14: two calls at M={M} differ (bit-identical demanded)")
        err = (y.float() - ref.float()).abs().max().item()
        errs.append(err)
        log(f"K14 p32_linear M={M} K={K} N={N}: max_abs_err={err:.3e}, max |ref| "
            f"{ref.float().abs().max().item():.3f} (tol 1e-2 + 1e-2 |ref|: one bf16 rounding)")
        if not torch.allclose(y.float(), ref.float(), rtol=1e-2, atol=1e-2):
            raise RuntimeError(f"K14 disagrees with its plain version at M={M}: {err}")
        if M == 8:
            ms = bench_ms(lambda: mp.p32_linear(x, w32, scale), device, lead_cycles=1_000_000)
            host = round(host_us(lambda: mp.p32_linear(x, w32, scale), device), 1)
            plain = bench_ms(lambda: mp.p32_linear_plain(x, w32, scale), device)
            wb = (w8.float() * scale).to(torch.bfloat16)
            dense = bench_ms(lambda: x @ wb, device, lead_cycles=1_000_000)
            bd = bound(nbytes(x, w32, scale, y), 2 * M * K * N, "bf16")
            log(f"K14 M={M}: kernel {ms:.4f} ms (host {host} us per call), plain {plain:.4f} ms, "
                f"dense bf16 matmul on the unpacked weight {dense:.4f} ms, bound "
                f"{bd['bound_ms']:.4f} ms "
                f"({bd['bound_by']}, {nbytes(w32) / 1e6:.1f} MB of packed weight)")
            rec["p32_linear"] = dict(ms=ms, plain_ms=plain, library_ms=dense, **bd, host_us=host,
                                     shape=f"x [{M},{K}] bf16 @ int32 [{kq},{N}], f32 scale")
            del wb
    rec["p32_linear"]["max_abs_err"] = max(errs)
    return rec


def run_packed_prefill(params, cfg, device, requests, wrappers):
    """Phase 6c: the 14-request greedy batch's prefill (chunks of 7, int8
    base, bf16 cache) with ``CULLAVO_FLASH_PACKED=1``: K13 in every layer of
    each chunk instead of K1.  K13 is K1's kernel behind maps its entry
    encodes, so the two prefills' logits must be ``torch.equal``; that
    equality cannot see a fault of the kernel they share, so both are also
    held against a third prefill whose attention is the plain version
    (``mha_reference``, the kernels' spec): the packed prefill's last-token
    logits within ``PACKED_LOGIT_TOL`` of it (largest) and within
    ``PACKED_LOGIT_MEAN_TOL`` on average.  The bounds must catch a fault:
    a prefill whose attention loses a key tile (``faulty_attention``) must
    land outside them; one whose keys are narrowed to fp8 is printed beside
    it, a fault these logits cannot tell from bf16 rounding.  K13 launched 32 per chunk and K1 never; prefill seconds of both
    forms in turns (K1, packed, packed, K1).  The A/B that JAX's comment
    leaves for other topologies.  Returns the packed run's counts."""
    import torch

    from cullavo_tpu_torch.models.llava import llama
    from cullavo_tpu_torch.models.llava.modeling import generate_prefill_chunked
    from cullavo_tpu_torch.ops import flash_attention as fa

    ids, mask, pix, _, T_pad = requests

    def prefill(packed, attention=None):
        os.environ["CULLAVO_FLASH_PACKED"] = "1" if packed else "0"
        if attention is not None:   # every layer's attention through this function
            llama.flash_attention = attention
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        st = generate_prefill_chunked(params, cfg, ids, pix, mask, T_pad + NEW_TOKENS, CHUNK,
                                      compute_dtype=torch.bfloat16)
        torch.cuda.synchronize(device)
        os.environ.pop("CULLAVO_FLASH_PACKED")
        llama.flash_attention = fa.flash_attention
        return st["logits"], time.perf_counter() - t0

    ref, t_k1 = prefill(False)
    (got, t_packed), counts = counted(wrappers, lambda: prefill(True))
    t_packed2 = prefill(True)[1]
    t_k1_2 = prefill(False)[1]
    spec = prefill(False, lambda q, k, v: fa.mha_reference(q, k, v))[0].float()
    same = torch.equal(got, ref)
    err = (got.float() - spec).abs()
    err_k1 = (ref.float() - spec).abs()
    caught = {}
    for fault in ("lost_key_tile", "fp8_keys"):
        bad = (prefill(False, faulty_attention(fault))[0].float() - spec).abs()
        caught[fault] = (round(bad.max().item(), 4), round(bad.mean().item(), 5))
    n_chunks = -(-BATCH // CHUNK)
    log(f"phase 6c, packed prefill: launches {counts}; last-token logits equal to the K1 "
        f"prefill's: {same} (largest difference "
        f"{(got.float() - ref.float()).abs().max().item():.4f}); against the plain-attention "
        f"prefill: packed largest {err.max().item():.4f} (tol {PACKED_LOGIT_TOL}), mean "
        f"{err.mean().item():.5f} (tol {PACKED_LOGIT_MEAN_TOL}); K1 largest "
        f"{err_k1.max().item():.4f}, mean {err_k1.mean().item():.5f}; |logits| up to "
        f"{spec.abs().max().item():.2f} (mean {spec.abs().mean().item():.3f}); planted faults "
        f"(largest, mean): {caught}")
    log(f"prefill s (batch {BATCH}, chunks of {CHUNK}, T {T_pad}), in turns: K1 {t_k1:.4f}, "
        f"packed {t_packed:.4f}, packed {t_packed2:.4f}, K1 {t_k1_2:.4f}")
    want = {"flash_packed": n_chunks * cfg.text.num_hidden_layers, "flash_fwd": 0}
    if any(counts[k] != n for k, n in want.items()):
        raise RuntimeError(f"packed prefill: launches {counts} != predicted {want}")
    if not same:
        raise RuntimeError("packed prefill: logits differ from the K1 prefill's")
    if not (torch.isfinite(got).all() and err.max().item() <= PACKED_LOGIT_TOL
            and err.mean().item() <= PACKED_LOGIT_MEAN_TOL):
        raise RuntimeError(f"packed prefill: last-token logits {err.max().item()} (mean "
                           f"{err.mean().item()}) from the plain-attention prefill's")
    worst, mean = caught["lost_key_tile"]
    if worst <= PACKED_LOGIT_TOL and mean <= PACKED_LOGIT_MEAN_TOL:
        raise RuntimeError(f"packed prefill: a lost key tile ({worst}, mean {mean}) passes the "
                           "bounds")
    return counts


def faulty_attention(fault):
    """Causal attention q [B, H, T, d] against k/v [B, H, T, d] as
    ``mha_reference`` computes it, with one planted fault, for phase 6c to
    measure what its bounds catch: ``lost_key_tile`` drops, for every query
    row, the 128-key tile just before the tile of its own position (K1's key
    tile, skipped once; the first tile's rows lose nothing), ``fp8_keys``
    rounds the keys to float8 e4m3 (a kernel that stages them too narrow)."""
    import torch

    from cullavo_tpu_torch.ops.flash_attention import NEG_INF

    def attention(q, k, v):
        if fault == "fp8_keys":
            k = k.to(torch.float8_e4m3fn).to(q.dtype)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
        i = torch.arange(q.shape[2], device=q.device)[:, None]
        j = torch.arange(k.shape[2], device=q.device)[None, :]
        keep = j <= i
        if fault == "lost_key_tile":
            keep = keep & (j // 128 != i // 128 - 1)
        probs = torch.softmax(torch.where(keep, scores, torch.full_like(scores, NEG_INF)), dim=-1)
        return torch.matmul(probs.to(q.dtype).float(), v.float()).to(q.dtype)
    return attention


# COCO panoptic's 133 categories: ids 1..200 with gaps in the real table;
# here 80 thing ids then 53 stuff ids, with gaps, for the contiguous map
PANOPTIC_CATEGORIES = ([{"id": 1 + i + i // 10, "name": f"thing{i}", "isthing": 1}
                        for i in range(80)]
                       + [{"id": 92 + 2 * i, "name": f"stuff{i}", "isthing": 0}
                          for i in range(53)])


def write_panoptic_dataset(root, n=LOOP_IMAGES, hw=LOOP_IMAGE_HW):
    """A COCO-panoptic dataset of ``n`` random images of ``hw`` written with
    the port's PNG writer (as ``.jpg`` names, the annotation's ``.png`` names
    renamed, as the reference's loader expects), id-encoded panoptic PNGs
    and a panopticapi JSON: per image two stuff halves, 2-4 thing boxes and,
    in image 0, one crowd segment.  Returns (json, image dir, panoptic dir)."""
    import numpy as np

    from cullavo_tpu_torch.data.coco_panoptic import id2rgb
    from cullavo_tpu_torch.data.png_io import write_png

    rng = np.random.default_rng(SEED + 12)
    img_dir, pan_dir = os.path.join(root, "train2017"), os.path.join(root, "panoptic_train2017")
    os.makedirs(img_dir)
    os.makedirs(pan_dir)
    H, W = hw
    things = [c["id"] for c in PANOPTIC_CATEGORIES if c["isthing"]]
    stuff = [c["id"] for c in PANOPTIC_CATEGORIES if not c["isthing"]]
    anns = []
    for i in range(n):
        write_png(os.path.join(img_dir, f"{i:012d}.jpg"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        ids = np.ones((H, W), np.int64)
        ids[H // 2:] = 2
        segs = [{"id": 1, "category_id": int(rng.choice(stuff)), "iscrowd": 0},
                {"id": 2, "category_id": int(rng.choice(stuff)), "iscrowd": 0}]
        for j in range(2 + i % 3):
            y0, x0 = int(rng.integers(0, H - 120)), int(rng.integers(0, W - 160))
            h, w = int(rng.integers(40, 120)), int(rng.integers(40, 160))
            ids[y0:y0 + h, x0:x0 + w] = 10 + j
            segs.append({"id": 10 + j, "category_id": int(rng.choice(things)), "iscrowd": 0})
        if i == 0:
            ids[:30, :30] = 99
            segs.append({"id": 99, "category_id": things[0], "iscrowd": 1})
        write_png(os.path.join(pan_dir, f"{i:012d}.png"), id2rgb(ids))
        anns.append({"image_id": i, "file_name": f"{i:012d}.png", "segments_info": segs})
    path = os.path.join(root, "panoptic_train2017.json")
    with open(path, "w") as f:
        json.dump({"images": [{"id": i, "file_name": f"{i:012d}.jpg", "height": H, "width": W}
                              for i in range(n)],
                   "annotations": anns, "categories": PANOPTIC_CATEGORIES}, f)
    return path, img_dir, pan_dir


def _same_tree(a, b, prefix=""):
    """Paths where two trees (dicts and lists of tensors, ints, None) differ
    bit for bit."""
    import torch

    if isinstance(a, (list, tuple)):
        return [p for i, (x, y) in enumerate(zip(a, b)) for p in _same_tree(
            x, y, f"{prefix}/{i}")] + ([prefix + "/<len>"] if len(a) != len(b) else [])
    if isinstance(a, dict):
        return [p for k in a for p in _same_tree(a[k], b[k], f"{prefix}/{k}")] + (
            [prefix + "/<keys>"] if sorted(a) != sorted(b) else [])
    if torch.is_tensor(a):
        return [] if (a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)) \
            else [prefix]
    return [] if a == b else [prefix]


def run_train_loop_path(snap, cfg, device, wrappers, smi, work):
    """Phase 12: ``entry.train`` on configs/cullavo_step1.yaml from phase 10's
    7B bf16 snapshot (``BITS: 4``, full width and depth) over a registered
    ``coco_panoptic`` dataset of 16 synthetic 480 x 640 images, batch 8, 1
    epoch (2 steps; it ran 2 epochs before phase 23 had to be paid for),
    ``SAVE_DIR`` a temporary directory: every loss finite; ``step_2`` and
    ``epoch0`` written; ``load_checkpoint(template=...)`` and
    ``load_reference_layout`` bit-equal to the trainable state they saved.
    Then ``RESUME_FROM`` epoch0 for 1
    step (the trainable partition bit-equal to the first run's final one
    before the step, the loss finite), then 1 step with
    ``CULLAVO_FLASH_PACKED=1`` without saving (its loss within 1e-3
    relative of the first run's step 1; K13 64 and K1-lse 32 launches), both
    on ``first_batch_dataset`` (run 1's first batch).
    Returns the packed run's launch counts and run 1's reference for phase
    22a (the dataset's registration, each step's metrics and seconds, the
    trainable partition's GB)."""
    import math

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.checkpoint.reference_layout import load_reference_layout
    from cullavo_tpu_torch.checkpoint.store import load_checkpoint

    t0 = time.perf_counter()
    json_file, img_dir, pan_dir = write_panoptic_dataset(os.path.join(work, "coco"))
    log(f"coco_panoptic dataset: {LOOP_IMAGES} images of {LOOP_IMAGE_HW} written in "
        f"{time.perf_counter() - t0:.2f} s")
    save_dir = os.path.join(work, "step1_out")
    base = {**TRAIN_CFG, "LOG_EVERY": 1,
            "MODEL": {"LLM": {**TRAIN_CFG["MODEL"]["LLM"], "LOAD_PATH": snap}},
            "DATASETS": {"TRAIN": LOOP_DATASET}}
    dataset = {"KIND": "coco_panoptic", "JSON": json_file, "IMAGE_DIR": img_dir,
               "PANOPTIC_DIR": pan_dir, "NUM_CLASSES": 133}
    cfg1 = {**base, "EPOCHS": 1, "SAVE_DIR": save_dir,
            "DATASETS": {"TRAIN": LOOP_DATASET, "REGISTER": {LOOP_DATASET: dataset}}}

    # record what each run's loop starts from, its step and save seconds
    real_loop = entry.train_loop
    seen = {}

    def loop(state, frozen, step_fn, data_iter_fn, steps_per_epoch, cfg, rng, log_fn=None,
             save_fn=None):
        seen.update(start=state, steps=[], saves=[])

        def step(*a):
            torch.cuda.synchronize(device)
            t = time.perf_counter()
            out = step_fn(*a)
            torch.cuda.synchronize(device)
            seen["steps"].append(time.perf_counter() - t)
            return out

        def save(*a):
            t = time.perf_counter()
            save_fn(*a)
            seen["saves"].append(time.perf_counter() - t)

        return real_loop(state, frozen, step, data_iter_fn, steps_per_epoch, cfg, rng,
                         log_fn, save if save_fn else None)

    def train(c):
        seen.clear()
        torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        res, counts = counted(wrappers, lambda: entry.train(c))
        wall = time.perf_counter() - t
        losses = [h["loss_llm"] for h in res["history"]]
        if not (losses and all(math.isfinite(x) for x in losses)):
            raise RuntimeError(f"train loop: bad losses {losses}")
        return res, counts, losses, dict(seen, wall=wall,
                                         peak=torch.cuda.max_memory_allocated(device) / 2**30)

    entry.train_loop = loop
    res1, counts1, losses1, info1 = train(cfg1)
    state1 = res1["state"]
    written = sorted(os.listdir(save_dir))
    log(f"train loop run 1 (K1): losses {losses1}; launches {counts1}; written {written}")
    if len(losses1) != 2 or state1.step != 2 or not {"step_2", "epoch0"} <= set(written):
        raise RuntimeError(f"train loop run 1: {len(losses1)} steps, wrote {written}")
    L = cfg.text.num_hidden_layers
    if counts1["flash_fwd_lse"] != 2 * 2 * L or counts1["flash_packed"]:
        raise RuntimeError(f"train loop run 1: launches {counts1}")
    t = time.perf_counter()
    back = load_checkpoint(save_dir, 2, template=state1)
    t_ckpt = time.perf_counter() - t
    bad = _same_tree({"t": back.trainable, "o": back.opt_state, "s": back.step},
                     {"t": state1.trainable, "o": state1.opt_state, "s": state1.step})
    t = time.perf_counter()
    ref_back = load_reference_layout(os.path.join(save_dir, "epoch0"), state1.trainable)
    t_ref = time.perf_counter() - t
    bad += _same_tree(ref_back, state1.trainable)
    log(f"step_2 read back with the TrainState template in {t_ckpt:.2f} s, epoch0 in "
        f"{t_ref:.2f} s: {len(bad)} leaves differ (bit-equal demanded)")
    if bad:
        raise RuntimeError(f"train loop: checkpoints read back differ: {bad[:5]}")
    du = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(save_dir) for f in fs)
    del back, ref_back
    ref = {"dataset": dataset, "history": res1["history"], "launches": counts1,
           "steps": [round(x, 4) for x in info1["steps"]],
           "trainable_gb": nbytes(*(t for _, t in _tree_leaves(state1.trainable))) / 1e9}
    final1 = state1.trainable
    del res1, state1
    torch.cuda.empty_cache()

    # runs 2 and 3: one step each, on run 1's first batch
    first = "coco_2017_train_panoptic_first_batch"
    one_step = {**base, "DATASETS": {"TRAIN": first, "REGISTER": {
        first: first_batch_dataset(dataset, work, base["BATCH_SIZE"])}}}
    cfg2 = {**one_step, "RESUME_FROM": os.path.join(save_dir, "epoch0", "CuLLaVO.pt")}
    res2, counts2, losses2, info2 = train(cfg2)
    bad = _same_tree(info2["start"].trainable, final1)
    log(f"train loop run 2 (RESUME_FROM epoch0): losses {losses2}; its trainable partition "
        f"before step 1: {len(bad)} leaves differ from run 1's final one (bit-equal demanded)")
    if bad or len(losses2) != 1 or info2["start"].opt_state["count"] != 0:
        raise RuntimeError(f"train loop: the resumed state differs: {bad[:5]}")
    del res2, info2["start"], final1
    torch.cuda.empty_cache()

    os.environ["CULLAVO_FLASH_PACKED"] = "1"
    res3, counts3, losses3, info3 = train({**base, "DATASETS": {"TRAIN": first}})
    os.environ.pop("CULLAVO_FLASH_PACKED")
    entry.train_loop = real_loop
    rel = abs(losses3[0] - losses1[0]) / abs(losses1[0])
    log(f"train loop run 3 (CULLAVO_FLASH_PACKED=1): losses {losses3}; launches {counts3}; "
        f"step-1 loss {rel:.3e} relative from run 1's (tol 1e-3)")
    want = {"flash_packed": 2 * L, "flash_fwd_lse": L, "flash_fwd": 0}
    if any(counts3[k] != n for k, n in want.items()) or not rel <= 1e-3:
        raise RuntimeError(f"train loop, packed: launches {counts3} (want {want}), "
                           f"step-1 loss {losses3[0]} vs {losses1[0]}")
    del res3
    torch.cuda.empty_cache()
    for label, info in (("run 1, K1", info1), ("run 2, resumed", info2),
                        ("run 3, packed", info3)):
        s = info["steps"]
        log(f"train loop {label} ({smi}): s per step {[round(x, 4) for x in s]}, median "
            f"{statistics.median(s[1:] if len(s) > 2 else s):.4f} s; checkpoint writes (step_N "
            f"+ epochN) {[round(x, 2) for x in info['saves']]} s; wall {info['wall']:.2f} s "
            f"(snapshot load and NF4 quantization included); peak memory {info['peak']:.2f} GiB")
    log(f"checkpoints on disk: {du / 1e9:.3f} GB (step_2, epoch0)")
    return counts3, ref


def run_matmul_probe(device, wrappers):
    """Phase 13: the port's matmul probe at JAX's defaults (M = 8, 24 stacked
    [4096, 11008] weights) with the p32 variants, on the card: every
    variant's JSON line, parity to the first within 2e-2 (the probe raises
    otherwise).  Returns its launch counts (K14: the parity call, a warm-up
    pass and 10 timed passes over the 24 weights)."""
    from cullavo_tpu_torch.scripts import matmul_probe as mp

    rows, counts = counted(wrappers, lambda: mp.main(M=8, L=24, p32=True, device=device))
    names = [r["variant"] for r in rows]
    if names != ["conv", "conv_pre", "conv_t", "s8s8", "conv_p32_xla", "p32_pallas", "bf16"]:
        raise RuntimeError(f"matmul probe: variants {names}")
    want = 1 + (1 + mp.REPS) * 24
    if counts["p32_linear"] != want:
        raise RuntimeError(f"matmul probe: K14 launches {counts['p32_linear']} != {want}")
    log(f"matmul probe launches: {counts}")
    return counts


def write_conversations(root):
    """A conversations dataset: ``STEP2_ROWS`` ShareGPT4V-style rows (one
    human/gpt turn each) over PNG images of ``STEP2_IMAGE_HW`` sizes in
    turns, written by the port's PNG writer, and ``rows.json``."""
    import numpy as np

    from cullavo_tpu_torch.data import png_io

    rng = np.random.default_rng(SEED + 14)
    rows = []
    for i in range(STEP2_ROWS):
        name = f"conv_{i:03d}.png"
        hw = STEP2_IMAGE_HW[i % len(STEP2_IMAGE_HW)]
        png_io.write_png(os.path.join(root, name), rng.integers(0, 256, hw + (3,), dtype=np.uint8))
        rows.append({"id": i, "image": name, "conversations": [
            {"from": "human", "value": "<image>\nWhat is in the picture?"},
            {"from": "gpt", "value": VL_ANSWERS[i % len(VL_ANSWERS)]}]})
    with open(os.path.join(root, "rows.json"), "w") as f:
        json.dump(rows, f)
    return os.path.join(root, "rows.json")


def check_step2_rows(out_dir, printed):
    """``lbk_new_version.json`` under ``out_dir``: a list of well-formed rows
    (image file written, as many boxes as classes, finite coordinates), as
    many as the run printed.  Returns the rows."""
    with open(os.path.join(out_dir, "lbk_new_version.json")) as f:
        made = json.load(f)
    bad = [r for r in made if not (
        set(r) == {"image", "boxes", "classes", "text"}
        and os.path.isfile(os.path.join(out_dir, r["image"]))
        and len(r["boxes"]) == len(r["classes"]) > 0
        and all(len(b) == 4 and all(math.isfinite(v) for v in b) for b in r["boxes"]))]
    if not isinstance(made, list) or bad or printed.get("rows") != len(made):
        raise RuntimeError(f"step2_pre: bad rows {bad[:2]} (printed {printed}, {len(made)} "
                           f"in {out_dir}/lbk_new_version.json)")
    return made


def run_step2_pre_path(snap, device, wrappers, smi, work):
    """Phase 14: step2_pre data generation at LLaVA-1.5-7B from phase 10's
    bf16 snapshot, over a registered conversations dataset of 12 rows
    (``--config_overrides``) with ``LOAD_PATH`` the snapshot
    (``--overrides``): ``STEP2_NEW`` sampled tokens, batch 8, so two chunks, the
    second padded by repetition.  (1) ``python -m cullavo_tpu_torch eval
    --conf_files configs/cullavo_step2_pre.yaml ...`` runs in phase 22c, on
    two ranks.
    (2) The main path: ``entry.main`` on the same
    arguments in this process, launches counted; the pipeline's ``generate``
    calls are recorded, their prefill and decode steps timed apart; exit
    and well-formed rows.  (3) The first chunk's call again with its
    recorded seed at 32 new tokens: equal to the first chunk's first 32.
    (4) On the first chunk's inputs at 32 new tokens:
    the sampled fused ``generate``, the greedy fused ``generate`` and
    ``generate_prefill`` + ``generate_decode``, each with prefill and steps
    timed apart (the sampler's cost and the early stop's host read apart);
    greedy fused = two-phase (a row that differs is reported with its top-2
    margin at the first differing step, and fails).  (5) ``_filter_logits``
    of the prefill's logits on the card equal to the CPU's.  Returns the
    launch counts of (2)."""
    import io

    import torch

    from cullavo_tpu_torch import entry
    from cullavo_tpu_torch.models.llava import modeling as tm
    from cullavo_tpu_torch.pipelines import cullavo_pipeline as cp

    root = os.path.join(work, "conversations")
    os.makedirs(root)
    rows_json = write_conversations(root)
    over = {"DATASETS.TEST": [STEP2_DATASET], "DATASETS.REGISTER": {STEP2_DATASET: {
        "KIND": "conversations", "JSON": rows_json, "IMAGE_ROOT": root}}}

    def argv(out_dir):
        return ["eval", "--conf_files", os.path.join(REPO, STEP2_CFG),
                "--config_overrides", json.dumps(over),
                "--overrides", "MODEL.LLM.LOAD_PATH", snap, "SAVE_DIR", out_dir,
                "MAX_NEW_TOKENS", str(STEP2_NEW)]

    # the pipeline's generate calls, and every prefill and decode loop timed
    # (a decode loop also keeps the host clock at each of its forwards: the
    # fused loop's per-step read of the device makes that a step's wall)
    calls, spans, forwards, stamps = [], [], [0], []
    originals = {"generate_prefill": tm.generate_prefill, "_decode_steps": tm._decode_steps,
                 "llava_forward": tm.llava_forward, "_sample_token": tm._sample_token}
    seen = []

    def timed(name):
        def run(*a, **kw):
            torch.cuda.synchronize(device)
            n0, t = forwards[0], time.perf_counter()
            out = originals[name](*a, **kw)
            torch.cuda.synchronize(device)
            end = time.perf_counter()
            spans.append((name, end - t, forwards[0] - n0, stamps[n0:] + [end]))
            return out
        return run

    def counting_forward(*a, **kw):
        forwards[0] += 1
        stamps.append(time.perf_counter())
        return originals["llava_forward"](*a, **kw)

    def recording_sample(logits, gen, *a):
        seen.append(logits.float().clone())
        return originals["_sample_token"](logits, gen, *a)

    def recorded_generate(params, cfg, ids, pix, mask, gen, max_len, rng, compute_dtype):
        seed = rng.initial_seed()
        out = tm.generate(params, cfg, ids, pix, mask, gen, max_len, rng=rng,
                          compute_dtype=compute_dtype)
        calls.append({"args": (params, cfg, ids, pix, mask), "gen": gen, "max_len": max_len,
                      "seed": seed, "dtype": compute_dtype, "out": out})
        return out

    def take_spans():
        got = {name: [(s, n, st) for k, s, n, st in spans if k == name]
               for name in ("generate_prefill", "_decode_steps")}
        spans.clear()
        stamps.clear()
        forwards[0] = 0
        return got

    tm.generate_prefill = timed("generate_prefill")
    tm._decode_steps = timed("_decode_steps")
    tm.llava_forward = counting_forward
    pipeline_generate, cp.generate = cp.generate, recorded_generate
    out_dir = os.path.join(work, "step2_pre_out")
    printed = io.StringIO()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        result, counts = counted(wrappers, lambda: entry.main(argv(out_dir), device=device))
    t_main = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30
    cp.generate = pipeline_generate
    main_spans = take_spans()
    log(f"  step2_pre entry.main printed: {printed.getvalue().strip()}")
    made = check_step2_rows(out_dir, result)
    layers = calls[0]["args"][1].text.num_hidden_layers
    steps = sum(n for _, n, _ in main_spans["_decode_steps"])
    if len(calls) != 2 or counts["flash_fwd"] != layers * len(calls) or \
            counts["wwin_decode"] != layers * steps:
        raise RuntimeError(f"step2_pre: {len(calls)} generate calls, K1/K4 launches "
                           f"{counts['flash_fwd']}/{counts['wwin_decode']} for {steps} steps")
    eos = calls[0]["gen"].eos_token_id
    emitted = 0
    for c in calls:
        tok = c["out"]
        if tok.shape != (STEP2_BATCH, STEP2_NEW) or tok.min() < 0 or \
                tok.max() >= c["args"][1].text.vocab_size:
            raise RuntimeError(f"step2_pre: bad tokens {tuple(tok.shape)}")
        emitted += sum(r.index(eos) + 1 if eos in r else STEP2_NEW for r in tok.tolist())
    pre_s = [s for s, _, _ in main_spans["generate_prefill"]]
    dec = main_spans["_decode_steps"]
    gen_s = sum(pre_s) + sum(s for s, _, _ in dec)
    # each step's wall from one forward to the next: the first and the last
    # STEP2_CHECK_NEW - 1 steps of each chunk (is a late step dearer?)
    k = STEP2_CHECK_NEW - 1
    ends = [[1e3 * (b - a) for a, b in zip(st, st[1:])] for _, _, st in dec]
    first_last = [(round(statistics.median(e[:k]), 3), round(statistics.median(e[-k:]), 3))
                  for e in ends]
    T = calls[0]["args"][2].shape[1]
    log(f"step2_pre main path ({smi}): entry.main {t_main:.3f} s (snapshot load included), "
        f"{len(calls)} chunks of {STEP2_BATCH} x prompt {T} tokens, cache {T + STEP2_NEW} "
        f"slots; prefill s {[round(s, 4) for s in pre_s]}; decode "
        f"{[round(s, 4) for s, _, _ in dec]} s over {[n for _, n, _ in dec]} steps = "
        f"{[round(1e3 * s / n, 3) for s, n, _ in dec]} ms per step (median of the first / "
        f"last {k} steps {first_last} ms); {emitted} tokens emitted "
        f"in {gen_s:.3f} s of generate = {emitted / gen_s:.1f} tokens/s; peak memory "
        f"{peak:.2f} GiB; K1 {counts['flash_fwd']} and K4 {counts['wwin_decode']} launches; "
        f"{len(made)} rows (random weights: a sampled text rarely parses into boxes)")

    first = calls[0]
    params, model_cfg, ids, pix, mask = first["args"]
    again = tm.generate(params, model_cfg, ids, pix, mask,
                        dataclasses.replace(first["gen"], max_new_tokens=STEP2_CHECK_NEW),
                        first["max_len"],
                        rng=torch.Generator(device=device).manual_seed(first["seed"]),
                        compute_dtype=first["dtype"])
    take_spans()
    if not torch.equal(again, first["out"][:, :STEP2_CHECK_NEW]):
        raise RuntimeError("step2_pre: the first chunk again from its seed gave other tokens")
    log(f"step2_pre sampled: the first chunk again from seed {first['seed']} at "
        f"{STEP2_CHECK_NEW} tokens: equal to its first {STEP2_CHECK_NEW}; tokens[0][:12] "
        f"{again[0, :12].tolist()}")

    short = T + STEP2_CHECK_NEW
    sampled = dataclasses.replace(first["gen"], max_new_tokens=STEP2_CHECK_NEW)
    greedy = tm.GenerationConfig(max_new_tokens=STEP2_CHECK_NEW, eos_token_id=-1)

    def sampled_fused():
        return tm.generate(params, model_cfg, ids, pix, mask, sampled, short,
                           compute_dtype=torch.bfloat16,
                           rng=torch.Generator(device=device).manual_seed(first["seed"]))

    def greedy_fused():
        return tm.generate(params, model_cfg, ids, pix, mask, greedy, short,
                           compute_dtype=torch.bfloat16)

    def two_phase():
        state = tm.generate_prefill(params, model_cfg, ids, pix, mask, short,
                                    compute_dtype=torch.bfloat16)
        outs["prefill logits"] = state["logits"].float().clone()
        return tm.generate_decode(params, model_cfg, state, greedy,
                                  compute_dtype=torch.bfloat16)

    # in turns, so that the host clock's drift from one run to the next
    # shows beside the differences
    variants = {"sampled fused": sampled_fused, "greedy fused": greedy_fused,
                "greedy two-phase": two_phase}
    split, outs = {name: [] for name in variants}, {}
    for turn in range(STEP2_TURNS):
        for name, run in variants.items():
            if turn == 0 and name == "greedy two-phase":
                tm._sample_token = recording_sample
            out = run()
            tm._sample_token = originals["_sample_token"]
            sp = take_spans()
            (pre, _, _), = sp["generate_prefill"]
            (d, n, _), = sp["_decode_steps"]
            split[name].append((pre, 1e3 * d / n))
            if turn == 0:
                outs[name] = out
    for name, f in originals.items():
        setattr(tm, name, f)
    fused, two, logits0 = outs["greedy fused"], outs["greedy two-phase"], outs["prefill logits"]
    differ = (fused != two).any(dim=1)
    for b in differ.nonzero().flatten().tolist():
        at = int((fused[b] != two[b]).nonzero()[0])
        top = torch.topk(seen[at][b], 2).values
        log(f"step2_pre: greedy row {b} differs at step {at}: fused {fused[b].tolist()}, "
            f"two-phase {two[b].tolist()}; top-2 margin there {float(top[0] - top[1]):.4f}")
    if differ.any():
        raise RuntimeError("step2_pre: the greedy fused generate is not the two-phase stream")
    med = {}
    for name, runs in split.items():
        med[name] = statistics.median(ms for _, ms in runs)
        log(f"step2_pre {name} ({smi}): {STEP2_BATCH} rows, cache {short} slots, "
            f"{STEP2_CHECK_NEW} new tokens, {STEP2_TURNS} turns: prefill "
            f"{[round(p, 4) for p, _ in runs]} s, decode {[round(ms, 3) for _, ms in runs]} "
            f"ms per step (median {med[name]:.3f})")
    log(f"step2_pre decode split ({smi}), medians: the sampler "
        f"{med['sampled fused'] - med['greedy fused']:.3f} ms per step (sampled fused - "
        f"greedy fused), the fused loop's host read "
        f"{med['greedy fused'] - med['greedy two-phase']:.3f} ms per step (greedy fused - "
        f"two-phase); greedy fused = two-phase over {STEP2_BATCH} rows x "
        f"{STEP2_CHECK_NEW} tokens")

    card_sets = []
    for k, p in ((50, 0.95), (0, 0.95), (50, 1.0)):
        gen = tm.GenerationConfig(do_sample=True, top_k=k, top_p=p)
        card = tm._filter_logits(logits0, gen).cpu()
        cpu = tm._filter_logits(logits0.cpu(), gen)
        if not torch.equal(card, cpu):
            raise RuntimeError(f"step2_pre: filtered logits (top_k {k}, top_p {p}) differ "
                               "between the card and the CPU")
        card_sets.append(int((card > tm.NEG_INF / 2).sum()))
    log(f"step2_pre filter: card = CPU on the prefill logits [{STEP2_BATCH}, "
        f"{logits0.shape[1]}]; kept tokens (top-k 50 + top-p 0.95 / top-p 0.95 / top-k 50): "
        f"{card_sets}")
    del params, calls, first, variants
    torch.cuda.empty_cache()
    return counts


PAR_RANKS = 2
PAR_TIMEOUT = 600                         # s a spawn of ranks may take
# two ranks against one process, relative, per path: (loss, grad_norm).  bf16
# compute: the halves' GEMMs round apart from the whole batch's.  From
# ``--par-calibrate`` (PERF.md §6).  Q-LoRA is deterministic: each
# limit lies between the largest sound reading (5.4e-5, 4.0e-4) and the
# local-denominator fault's (1.3e-4, 6.2e-4).  The X-Decoder's step is not
# (one process twice: 5.2e-5, 3.9e-4) and its sound readings reach 6.6e-5 and
# 5.4e-3, as far as that fault's: the limits sit 3x and ~4x above them, the
# grad_norm limit 26x below the missing gradient all-reduce's 0.52
PAR_TOL = {"qlora": (8e-5, 5e-4), "xtrain": (2e-4, 2e-2)}
# the faults ``--par-calibrate`` plants on two ranks: each rank's loss over
# its own denominator (per-rank means averaged, as DDP does), or no
# all-reduce of the gradient (each rank steps on its own rows' gradient)
PAR_FAULTS = ("local_denominator", "no_grad_allreduce")
# the fault ``--par-calibrate sharded`` plants on the sharded runs: the clip's
# and the metric's norm over this rank's gradient shards only
SHARD_FAULTS = ("local_norm",)
# phase 23a: a MESH_FSDP 2 rank's resident memory after its run, at most this
# share of a phase 22a data-axis rank's (the state halves: about 0.5)
SHARD_RESIDENT_MAX = 0.6
PAR_CAL_SEEDS = (0, 1, 2)
STEP2_PAR_NEW, STEP2_PAR_BATCH = 32, 4    # phase 22c: 12 rows, 6 a rank, 2 chunks each
# each kernel's wrapper (its module, its function); every wrapper counts its
# kernel's launches in ``.launches``
WRAPPERS = {
    "flash_fwd": ("ops.flash_attention", "flash_attention"),
    "quant_rows": ("ops.nf4", "quantize_rows"), "int8_linear": ("ops.nf4", "int8_linear"),
    "wwin_decode": ("ops.wwin_decode", "wwin_decode_smajor"),
    "wwin_decode_q8": ("ops.wwin_decode", "wwin_decode_smajor_q8"),
    "nf4_linear_planar": ("ops.nf4", "nf4_linear_planar"),
    "nf4_dequant_planar": ("ops.nf4", "nf4_dequant_planar"),
    "flash_fwd_lse": ("ops.flash_attention", "flash_lse"),
    "flash_rows": ("ops.flash_attention", "flash_rows"),
    "ms_deform_attn": ("ops.msdeform", "ms_deform_attn_kernel"),
    "focal_ctx": ("ops.focal", "focal_ctx_kernel"),
    "nf4_linear_q4": ("ops.nf4", "nf4_linear_q4"), "nf4_dequant_q4": ("ops.nf4", "nf4_dequant_q4"),
    "flash_decode": ("ops.flash_attention", "decode_partials"),
    "flash_packed": ("ops.flash_attention", "flash_attention_packed"),
    "p32_linear": ("scripts.matmul_probe", "p32_linear")}


def load_wrappers():
    import importlib

    return {name: getattr(importlib.import_module(f"cullavo_tpu_torch.{mod}"), fn)
            for name, (mod, fn) in WRAPPERS.items()}


def plant_fault(name):
    """One of ``PAR_FAULTS``, patched into this rank's modules."""
    from cullavo_tpu_torch.parallel import mesh
    from cullavo_tpu_torch.parallel.mesh import BatchPart
    from cullavo_tpu_torch.trainer import step

    if name == "local_denominator":   # each denominator W x this rank's own
        own = step.loss_weight_sum
        step.loss_weight_sum = lambda labels, mask, weights, parallel: (
            own(labels, mask, weights) * parallel.axis_size("batch"))
        BatchPart.sum = lambda self, x: x.detach().clone() * self.ctx.axis_size("batch")
    elif name == "no_grad_allreduce":
        mesh.all_reduce_tree = lambda leaves, group=None: list(leaves)
    elif name == "local_norm":
        from cullavo_tpu_torch.trainer.optimizer import global_norm

        mesh.Layout.global_norm = lambda self, grads: global_norm(grads)
    else:
        raise ValueError(f"no planted fault {name!r}: {PAR_FAULTS + SHARD_FAULTS}")


def rank_main(argv):
    """``chip_smoke.py --rank [--fault NAME] -- ARGS``: one process of phase
    22's runs (or of ``--par-calibrate``): ``entry.main(ARGS)`` with every
    wrapper's launch count set to 0 just before it, then one JSON line
    ``{"rank_report": {"launches", "history"}}`` (a training run's steps'
    loss and grad_norm); TF32 off, as phase 1 sets it.  ``--fault``:
    ``plant_fault``'s, for ``--par-calibrate`` only."""
    import torch

    sep = argv.index("--")
    opts, args = argv[:sep], argv[sep + 1:]
    sys.path.insert(0, REPO)
    from cullavo_tpu_torch import entry

    # phase 1's settings, under which the in-process runs compared with
    # these ranks ran
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    if "--fault" in opts:
        plant_fault(opts[opts.index("--fault") + 1])
    wrappers = load_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = entry.main(args)
    hist = out.get("history") if isinstance(out, dict) else None
    keys = ("loss_llm", "loss_total", "grad_norm")
    print(json.dumps({"rank_report": {
        "launches": {name: w.launches for name, w in wrappers.items()},
        "history": [{k: h[k] for k in keys if k in h} for h in hist] if hist else None}}),
        flush=True)


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(label, argvs, work, timeout=PAR_TIMEOUT, fault=None):
    """``len(argvs)`` ranks of ``rank_main`` (``entry.main`` as ``python -m
    cullavo_tpu_torch`` runs it) on this card (the launcher's env contract:
    ``CULLAVO_NUM_PROCS``, ``CULLAVO_PROC_ID``, ``CULLAVO_COORDINATOR`` at a
    free local port; ``CULLAVO_DIST_BACKEND`` gloo, since NCCL takes one
    rank a device; one argv: one process, no group), their output in files
    under ``work``.  A rank that exits non-zero, or the time limit, stops
    every rank and raises.  Returns each rank's (stdout, stderr), its
    report and the wall s."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        CULLAVO_NUM_PROCS=str(len(argvs)), CULLAVO_COORDINATOR=f"127.0.0.1:{port}",
        CULLAVO_DIST_BACKEND="gloo")
    procs, files = [], []
    t0 = time.perf_counter()
    for r, argv in enumerate(argvs):
        out, err = (open(os.path.join(work, f"{label}_rank{r}.{x}"), "w") for x in ("out", "err"))
        files.append((out, err))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--rank"]
            + (["--fault", fault] if fault else []) + ["--", *argv],
            cwd=REPO, env=dict(env, CULLAVO_PROC_ID=str(r)), stdout=out, stderr=err))
    while (any(p.poll() is None for p in procs) and time.perf_counter() - t0 < timeout
           and not any(p.poll() not in (None, 0) for p in procs)):
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for (out, err), p in zip(files, procs):
        out.close()
        err.close()
        with open(out.name) as fo, open(err.name) as fe:
            texts.append((fo.read(), fe.read()))
    for r, (p, (_, err)) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            raise RuntimeError(f"{label}: rank {r} exited {p.returncode} after {wall:.1f} s:\n"
                               + "\n".join(err.strip().splitlines()[-12:]))
    reports = [json.loads([ln for ln in out.splitlines() if ln.startswith('{"rank_report"')][
        -1])["rank_report"] for out, _ in texts]
    return texts, reports, wall


def _rank_lines(texts):
    """Each rank's last ``{"rank": ...}`` JSON line of stdout."""
    return [json.loads([ln for ln in out.splitlines() if ln.startswith('{"rank"')][-1])
            for out, _ in texts]


def _rel(got, want):
    """The worst relative gap of two lists of floats."""
    if len(got) != len(want):
        return math.inf
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))


def _held(label, got, want, tol):
    rel = _rel(got, want)
    if not rel <= tol:
        raise RuntimeError(f"{label}: {got} against one process's {want} (tol {tol} relative)")
    return rel


def _same_launches(label, reports, want):
    """Every rank launched each kernel as often as the one-process run of
    the same steps (a kernel launches per layer and step, whatever a
    rank's share of the rows)."""
    got = [r["launches"] for r in reports]
    if any(g != want for g in got):
        raise RuntimeError(f"{label}: launches per rank {got}, one process {want}")
    return got


def qlora_argv(snap, dataset, save=None, seed=None, epochs=2, grid=None):
    """Phase 22a's command line: configs/cullavo_step1.yaml from ``snap``
    over the registered ``dataset``, ``epochs`` epochs (2: 4 steps of 8),
    the ``MESH_*`` of ``grid``; ``SAVE_DIR`` and ``SEED`` where given."""
    over = {"DATASETS.TRAIN": LOOP_DATASET, "DATASETS.REGISTER": {LOOP_DATASET: dataset},
            **(grid or {})}
    return (["train", "--conf_files", os.path.join(REPO, "configs/cullavo_step1.yaml"),
             "--config_overrides", json.dumps(over), "--overrides", "EPOCHS", str(epochs),
             "LOG_EVERY", "1", "MODEL.LLM.LOAD_PATH", snap]
            + (["SAVE_DIR", save] if save else [])
            + (["SEED", str(seed)] if seed is not None else []))


def _step_seconds(texts):
    """Each step's seconds from rank 0's loop log (``step_s`` is the running
    mean of the steps so far)."""
    logs = [ast.literal_eval(ln) for ln in texts[0][1].splitlines() if ln.startswith("{'epoch'")]
    avg = [d["step_s"] for d in logs]
    return [avg[0]] + [(i + 1) * avg[i] - i * avg[i - 1] for i in range(1, len(avg))]


def _scaled_launches(launches, steps, of):
    """A run's launch counts for ``steps`` of its ``of`` steps (each kernel
    launches the same number of times every step)."""
    if any(n * steps % of for n in launches.values()):
        raise RuntimeError(f"launches {launches} are not {of} equal steps")
    return {k: n * steps // of for k, n in launches.items()}


def _memory(lines):
    """Each rank's resident, step-peak and load-peak GiB, rounded."""
    return {k: [round(ln[k], 2) for ln in lines] for k in ("resident_gib", "peak_gib",
                                                          "load_peak_gib") if k in lines[0]}


def run_parallel_train_path(snap, smi, work, ref):
    """Phase 22a: ``python -m cullavo_tpu_torch train --conf_files
    configs/cullavo_step1.yaml`` as two ranks on this card over Gloo, from
    phase 10's 7B snapshot (``BITS: 4``, full width and depth) over phase
    12's dataset, ``EPOCHS 1``: the global batch of 8 x 1024 split 4 + 4, 2
    steps, LoRA dropout on.  Each step's ``loss_llm`` and ``grad_norm``
    equal on the two ranks and within ``PAR_TOL["qlora"]`` relative of
    phase 12's one-process run of the same config and ``SEED`` (its first 2
    steps); each rank launched every kernel as often a step as that run
    (K1-lse 2 x 32 a step, K7); rank 0 writes step_2 and epoch0, rank 1
    (its own ``SAVE_DIR``) nothing (then removed: phase 23 writes its own).
    s per step (rank 0's log), the gradient all-reduce's ms a step and
    share (host-staged over Gloo: device -> host, the loopback, host ->
    device; not an NCCL figure), each rank's resident GiB after the run, its
    step peak and its load's peak.  Returns those, each rank's launches and
    its NF4 base bytes (phase 23's yardsticks)."""
    saves = [os.path.join(work, f"step1_ranks_{r}") for r in range(PAR_RANKS)]
    texts, reports, wall = run_ranks("qlora", [qlora_argv(snap, ref["dataset"], s, epochs=1)
                                               for s in saves], work)
    lines = _rank_lines(texts)
    want_l = [h["loss_llm"] for h in ref["history"][:2]]
    want_n = [h["grad_norm"] for h in ref["history"][:2]]
    if any(ln["loss_llm"] != lines[0]["loss_llm"] or ln["grad_norm"] != lines[0]["grad_norm"]
           for ln in lines):
        raise RuntimeError(f"two-rank Q-LoRA: the ranks disagree: {lines}")
    tol_l, tol_n = PAR_TOL["qlora"]
    rel_l = _held("two-rank Q-LoRA loss_llm", lines[0]["loss_llm"], want_l, tol_l)
    rel_n = _held("two-rank Q-LoRA grad_norm", lines[0]["grad_norm"], want_n, tol_n)
    launches = _same_launches("two-rank Q-LoRA", reports,
                              _scaled_launches(ref["launches"], 2, len(ref["history"])))
    written = sorted(os.listdir(saves[0]))
    if written != ["epoch0", "step_2"] or os.path.exists(saves[1]):
        raise RuntimeError(f"two-rank Q-LoRA: rank 0 wrote {written}, rank 1 "
                           f"{os.listdir(saves[1]) if os.path.exists(saves[1]) else 'nothing'}")
    shutil.rmtree(saves[0])
    step_s = _step_seconds(texts)
    s_step = step_s[-1]
    ar = lines[0]["allreduce_ms"]
    mem = _memory(lines)
    log(f"two-rank Q-LoRA at 7B ({smi}; 2 processes on one card over Gloo): loss_llm "
        f"{lines[0]['loss_llm']} (one process {want_l}, worst {rel_l:.2e} relative, tol "
        f"{tol_l}), grad_norm {lines[0]['grad_norm']} (one process {want_n}, worst "
        f"{rel_n:.2e}, tol {tol_n}); equal on both ranks; launches per rank as one process's "
        f"2 steps ({ {k: n for k, n in launches[0].items() if n} }); rank 0 wrote {written}, "
        "rank 1 nothing")
    log(f"two-rank Q-LoRA ({smi}): {s_step:.4f} s at step 2 (steps "
        f"{[round(x, 4) for x in step_s]}; one process at batch 8 {ref['steps']}); gradient "
        f"all-reduce (Gloo, host-staged, {ref['trainable_gb']:.3f} GB of f32 gradients) "
        f"{[round(x, 2) for x in ar]} ms, {ar[-1] / 1e3 / s_step:.1%} of step 2; GiB per rank "
        f"{mem}; wall {wall:.1f} s (two process starts, two snapshot loads, 2 steps, the "
        "saves)")
    return {"s_per_step": s_step, "allreduce_ms": ar, "launches": launches,
            "base_bytes": lines[0]["base_bytes"], **mem}


def first_batch_dataset(dataset, work, n):
    """A copy of a coco_panoptic registration whose JSON holds only the ``n``
    records of its first batch, ordered so that epoch 0 of the copy
    (``np.random.default_rng(0)``'s permutation, as ``entry.train`` draws
    it) takes them in the same order: one step of it is the first step of
    the original."""
    import numpy as np

    with open(dataset["JSON"]) as f:
        info = json.load(f)
    anns = info["annotations"]
    first = np.random.default_rng(0).permutation(len(anns))[:n]
    order = np.random.default_rng(0).permutation(n)
    picked = [None] * n
    for j in range(n):
        picked[order[j]] = anns[first[j]]
    info["annotations"] = picked
    path = os.path.join(work, "first_batch.json")
    with open(path, "w") as f:
        json.dump(info, f)
    return dict(dataset, JSON=path)


def _sharded_report(label, texts, reports, want_hist, want_launches, key, tol, smi, wall,
                    saves, written_want):
    """Phase 23's checks of one run of two ranks: the ranks agree, each
    step's loss and grad_norm within ``tol`` of the one-process run's same
    steps, each rank's launches that run's, only rank 0 wrote
    ``written_want`` (then removed).  Logs the step seconds, the gathers'
    and reductions' ms and share, the memory; returns the rank lines and
    the launches."""
    lines = _rank_lines(texts)
    want_l, want_n = [h[key] for h in want_hist], [h["grad_norm"] for h in want_hist]
    if any(ln[key] != lines[0][key] or ln["grad_norm"] != lines[0]["grad_norm"]
           for ln in lines):
        raise RuntimeError(f"{label}: the ranks disagree: {lines}")
    rel_l = _held(f"{label} {key}", lines[0][key], want_l, tol[0])
    rel_n = _held(f"{label} grad_norm", lines[0]["grad_norm"], want_n, tol[1])
    launches = _same_launches(label, reports, want_launches)
    written = sorted(os.listdir(saves[0]))
    if written != written_want or os.path.exists(saves[1]):
        raise RuntimeError(f"{label}: rank 0 wrote {written}, rank 1 "
                           f"{os.listdir(saves[1]) if os.path.exists(saves[1]) else 'nothing'}")
    step_s = lines[0].get("step_s") or _step_seconds(texts)
    gather, reduce = lines[0]["gather_ms"], lines[0]["allreduce_ms"]
    share = [(g + r) / 1e3 / s for g, r, s in zip(gather, reduce, step_s)]
    log(f"{label} ({smi}; 2 processes on one card over Gloo): {key} {lines[0][key]} (one "
        f"process {want_l}, worst {rel_l:.2e} relative, tol {tol[0]}), grad_norm "
        f"{lines[0]['grad_norm']} (one process {want_n}, worst {rel_n:.2e}, tol {tol[1]}); "
        f"equal on both ranks; launches per rank as one process's "
        f"({ {k: n for k, n in launches[0].items() if n} }); rank 0 wrote {written}, rank 1 "
        "nothing")
    log(f"{label} ({smi}): s per step {[round(x, 4) for x in step_s]}; gathers (with their "
        f"backward reduce-scatters) {[round(x, 1) for x in gather]} ms, gradient reductions "
        f"{[round(x, 1) for x in reduce]} ms, together {[f'{x:.1%}' for x in share]} of the "
        f"step (Gloo, host-staged: not an NCCL figure); GiB per rank {_memory(lines)}; wall "
        f"{wall:.1f} s")
    return lines, launches


def run_sharded_train_path(snap, smi, work, ref, par):
    """Phase 23a-b: phase 22a's command line as two ranks over Gloo under
    (a) ``MESH_FSDP: 2``, ``EPOCHS 1`` (2 steps of 8 x 1024, each rank 4
    rows), (b) ``MESH_TENSOR: 2`` on ``first_batch_dataset`` (1 step, each
    rank all 8 rows): the checks of ``_sharded_report`` against phase 12's
    run 1 (``PAR_TOL["qlora"]``; K1-lse 2 x 32 and K7 672 a step), each
    rank's NF4 base bytes half of a 22a rank's, and (a)'s resident GiB at
    most ``SHARD_RESIDENT_MAX`` of a 22a rank's (``par``: 22a's return).
    Returns each run's launches and memory."""
    n_ref = len(ref["history"])
    out = {}
    for tag, grid, dataset, steps in (
            ("fsdp", {"MESH_FSDP": 2}, ref["dataset"], 2),
            ("tensor", {"MESH_TENSOR": 2}, first_batch_dataset(ref["dataset"], work, 8), 1)):
        saves = [os.path.join(work, f"step1_{tag}_{r}") for r in range(PAR_RANKS)]
        texts, reports, wall = run_ranks(
            f"qlora_{tag}", [qlora_argv(snap, dataset, sv, epochs=1, grid=grid) for sv in saves],
            work)
        lines, launches = _sharded_report(
            f"Q-LoRA at 7B under {grid}", texts, reports, ref["history"][:steps],
            _scaled_launches(ref["launches"], steps, n_ref), "loss_llm", PAR_TOL["qlora"], smi,
            wall, saves, ["epoch0", f"step_{steps}"])
        shutil.rmtree(saves[0])
        base = [ln["base_bytes"] for ln in lines]
        if base != [par["base_bytes"] // 2] * PAR_RANKS:
            raise RuntimeError(f"Q-LoRA under {grid}: NF4 base bytes per rank {base}, a 22a "
                               f"rank's {par['base_bytes']}")
        mem = _memory(lines)
        out[tag] = {"launches": launches, **mem}
        log(f"Q-LoRA under {grid} ({smi}): each rank holds {base[0] / 1e9:.3f} GB of the NF4 "
            f"base (a 22a rank {par['base_bytes'] / 1e9:.3f} GB); resident GiB per rank "
            f"{mem['resident_gib']} against 22a's {par['resident_gib']} "
            f"({max(mem['resident_gib']) / max(par['resident_gib']):.1%}); step peak "
            f"{mem['peak_gib']} (22a {par['peak_gib']}); load peak {mem['load_peak_gib']} (22a "
            f"{par['load_peak_gib']})")
    ratio = max(out["fsdp"]["resident_gib"]) / max(par["resident_gib"])
    if not ratio <= SHARD_RESIDENT_MAX:
        raise RuntimeError(f"Q-LoRA under MESH_FSDP 2: a rank keeps {ratio:.1%} of a 22a "
                           f"rank's resident memory (at most {SHARD_RESIDENT_MAX:.0%})")
    return out


def run_sharded_xtrain_path(work, smi, ref):
    """Phase 23c: phase 22b's command line under ``MESH_FSDP: 2`` (FocalNet-L
    + FPN at 512², bf16, remat; 2 steps of 8, each rank 4 images): the
    checks of ``_sharded_report`` against phase 15's in-process run
    (``PAR_TOL["xtrain"]``; K10 2 x 48), rank 0's checkpoint read back
    finite.  Returns each rank's launches and memory."""
    from cullavo_tpu_torch.checkpoint.store import load_checkpoint
    from cullavo_tpu_torch.utils.tree import tree_leaves

    over = {"DATASETS.TRAIN": [XTRAIN_DATASET], "DATASETS.REGISTER": {XTRAIN_DATASET: ref["spec"]},
            "MESH_FSDP": PAR_RANKS}
    saves = [os.path.join(work, f"xtrain_fsdp_{r}") for r in range(PAR_RANKS)]
    texts, reports, wall = run_ranks("xtrain_fsdp", [xtrain_argv(over, sv) for sv in saves], work)
    lines, launches = _sharded_report(
        "X-Decoder joint training under {'MESH_FSDP': 2}", texts, reports, ref["history"],
        ref["launches"], "loss_total", PAR_TOL["xtrain"], smi, wall, saves, ["step_2"])
    ckpt = tree_leaves(load_checkpoint(saves[0])["params"])
    if not all(np_isfinite(a) for a in ckpt):
        raise RuntimeError("X-Decoder under MESH_FSDP 2: a leaf of the checkpoint is not finite")
    return {"launches": launches, **_memory(lines)}


def run_parallel_xtrain_path(work, smi, ref, rec):
    """Phase 22b: ``python -m cullavo_tpu_torch train --conf_files
    configs/xdecoder_train.yaml`` with ``MESH_DATA: 2`` as two ranks over
    Gloo on phase 15's dataset (FocalNet-L + FPN at 512², bf16, remat; 16
    images: 2 steps of 8 split 4 + 4): each step's ``loss_total`` and
    ``grad_norm`` equal on both ranks and within ``PAR_TOL["xtrain"]`` of
    phase 15's one-process ``entry.train`` on the same arguments; each rank
    launched every kernel as often as that run (K10 2 x 48); rank 0 writes
    the checkpoint (read back: every leaf finite), rank 1 nothing.  s per
    step, the all-reduce's ms, peak GiB per rank (each a fresh process of
    4 images a step: phase 15's ``peak_fresh_process``).  Returns those
    and each rank's launches."""
    over = {"DATASETS.TRAIN": [XTRAIN_DATASET], "DATASETS.REGISTER": {XTRAIN_DATASET: ref["spec"]},
            "MESH_DATA": PAR_RANKS}
    saves = [os.path.join(work, f"xtrain_ranks_{r}") for r in range(PAR_RANKS)]
    texts, reports, wall = run_ranks("xtrain", [xtrain_argv(over, s) for s in saves], work)
    lines = _rank_lines(texts)
    want_l = [h["loss_total"] for h in ref["history"]]
    want_n = [h["grad_norm"] for h in ref["history"]]
    if any(ln["loss_total"] != lines[0]["loss_total"] or ln["grad_norm"] != lines[0]["grad_norm"]
           for ln in lines):
        raise RuntimeError(f"two-rank X-Decoder: the ranks disagree: {lines}")
    tol_l, tol_n = PAR_TOL["xtrain"]
    rel_l = _held("two-rank X-Decoder loss_total", lines[0]["loss_total"], want_l, tol_l)
    rel_n = _held("two-rank X-Decoder grad_norm", lines[0]["grad_norm"], want_n, tol_n)
    launches = _same_launches("two-rank X-Decoder", reports, ref["launches"])
    from cullavo_tpu_torch.checkpoint.store import load_checkpoint
    from cullavo_tpu_torch.utils.tree import tree_leaves

    ckpt = tree_leaves(load_checkpoint(saves[0])["params"])
    if os.listdir(saves[0]) != ["step_2"] or os.path.exists(saves[1]) or not all(
            np_isfinite(a) for a in ckpt):
        raise RuntimeError(f"two-rank X-Decoder: rank 0 wrote {os.listdir(saves[0])}, "
                           f"finite: {all(np_isfinite(a) for a in ckpt)}")
    peaks = [ln["peak_gib"] for ln in lines]
    rec["focal_ctx"]["xdecoder_train"]["peak_fresh_process"] = {
        "gib_per_rank": peaks, "images_per_rank_step": XDEC_BATCH // PAR_RANKS}
    log(f"two-rank X-Decoder joint training ({smi}; MESH_DATA 2, Gloo, one card): loss_total "
        f"{lines[0]['loss_total']} (one process {want_l}, worst {rel_l:.2e} relative, tol "
        f"{tol_l}), grad_norm {lines[0]['grad_norm']} (one process {want_n}, worst "
        f"{rel_n:.2e}, tol {tol_n}); launches per rank as one process's "
        f"({ {k: n for k, n in launches[0].items() if n} }); s per step "
        f"{[round(x, 3) for x in lines[0]['step_s']]} (rank 0), gradient all-reduce "
        f"{[round(x, 2) for x in lines[0]['allreduce_ms']]} ms; peak GiB per rank (fresh "
        f"processes, 4 images a step) {[round(x, 2) for x in peaks]}; GiB per rank "
        f"{_memory(lines)}; wall {wall:.1f} s")
    return {"step_s": lines[0]["step_s"], "peak_gib": peaks, "launches": launches}


def run_parallel_step2_path(snap, smi, work, layers):
    """Phase 22c: step2_pre as two ranks of ``python -m cullavo_tpu_torch eval
    --conf_files configs/cullavo_step2_pre.yaml`` over Gloo, from phase 10's
    7B bf16 snapshot, over 12 conversation rows (6 a rank, chunks of
    ``STEP2_PAR_BATCH``), ``STEP2_PAR_NEW`` sampled tokens (the command
    line's run of phase 14, at cut depth): both ranks exit 0 and print the
    same row count, rank 0's ``lbk_new_version.json`` holds that many
    well-formed rows, every image named by its global index; each rank
    launched K1 once a layer and chunk and K4 a whole number of decode
    steps of every layer, at most ``STEP2_PAR_NEW`` a chunk (the sampled
    rows' ends decide).  Returns each rank's launches."""
    root = os.path.join(work, "step2_par_rows")
    os.makedirs(root)
    rows = write_conversations(root)
    out_dir = os.path.join(work, "step2_par_out")
    over = {"DATASETS.TEST": [STEP2_DATASET + "_par"], "DATASETS.REGISTER": {
        STEP2_DATASET + "_par": {"KIND": "conversations", "JSON": rows, "IMAGE_ROOT": root}}}
    argv = ["eval", "--conf_files", os.path.join(REPO, STEP2_CFG), "--config_overrides",
            json.dumps(over), "--overrides", "MODEL.LLM.LOAD_PATH", snap, "SAVE_DIR", out_dir,
            "MAX_NEW_TOKENS", str(STEP2_PAR_NEW), "BATCH_SIZE", str(STEP2_PAR_BATCH)]
    texts, reports, wall = run_ranks("step2", [argv] * PAR_RANKS, work)
    printed = [json.loads([ln for ln in out.strip().splitlines()
                           if not ln.startswith('{"rank_report"')][-1]) for out, _ in texts]
    made = check_step2_rows(out_dir, printed[0])
    names = {r["image"] for r in made}
    if printed[1] != printed[0] or not names <= {f"step2_{i}.png" for i in range(STEP2_ROWS)}:
        raise RuntimeError(f"two-rank step2_pre: printed {printed}, images {sorted(names)}")
    chunks = -(-(STEP2_ROWS // PAR_RANKS) // STEP2_PAR_BATCH)
    launches = [r["launches"] for r in reports]
    for c in launches:
        steps, rest = divmod(c["wwin_decode"], layers)
        if c["flash_fwd"] != layers * chunks or rest or not 0 < steps <= chunks * STEP2_PAR_NEW:
            raise RuntimeError(f"two-rank step2_pre: K1/K4 launches per rank "
                               f"{[(x['flash_fwd'], x['wwin_decode']) for x in launches]}")
    log(f"two-rank step2_pre ({smi}; LLaVA-1.5-7B bf16, {STEP2_PAR_NEW} tokens, Gloo): both "
        f"ranks printed {printed[0]}; {len(made)} rows written once by rank 0; K1/K4 launches "
        f"per rank {[(x['flash_fwd'], x['wwin_decode']) for x in launches]} ({chunks} chunks "
        f"of {layers} layers); wall {wall:.1f} s (two process starts, two snapshot loads, "
        f"{chunks} chunks a rank)")
    return launches


def run_nccl_step(device, smi, wrappers):
    """Phase 22d: one rank in an NCCL process group (world size 1, this
    process): the Q-LoRA step of LLaVA-1.5-7B's width at 2 LLM layers (NF4
    base, r 64, dropout on, bf16 compute, batch 8 x 1024) through a
    ``Layout`` of the trainable tree on that grid (its reductions span one
    rank, so they make no collective) bit-equal to the same step without a
    process group: loss, grad_norm and every updated leaf; each step's
    launches counted, equal, K1-lse 2 x 2 (forward and remat, 2 layers) and
    K7 launched; then an NCCL all-reduce of the step's loss on the card,
    equal to the loss.  Returns the step's launches with the group."""
    import torch
    import torch.distributed as dist

    from cullavo_tpu_torch.models.llava import lora as lora_mod
    from cullavo_tpu_torch.models.llava.config import LlavaConfig
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params
    from cullavo_tpu_torch.parallel import Layout, ParallelContext
    from cullavo_tpu_torch.trainer.optimizer import cullavo_optimizer
    from cullavo_tpu_torch.trainer.step import TrainState, make_train_step
    from cullavo_tpu_torch.utils.tree import tree_map

    cfg = LlavaConfig()
    cfg = dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, num_hidden_layers=2))
    params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(SEED + 62),
                               device, dtype=torch.bfloat16)
    params = lora_mod.maybe_quantize_base(params, 4)
    lcfg = lora_mod.LoraConfig(r=64, alpha=16.0, dropout=0.05)
    lora = lora_mod.init_lora_params(params, cfg, lcfg,
                                     torch.Generator(device=device).manual_seed(SEED + 63))
    trainable = tree_map(lambda t: t.float(), lora_mod.trainable_partition(params, lora))
    frozen = lora_mod.strip_trainable(params)
    batch, _ = make_train_batch(cfg, device)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            world_size=1, rank=0)
    backend = dist.get_backend()
    out = []
    for layout in (None, Layout(ParallelContext(), trainable)):
        norm = {} if layout is None else {"norm_fn": layout.global_norm}
        tx = cullavo_optimizer(2e-5, 1000, grad_clip=10.0, **norm)
        step = make_train_step(cfg, lcfg, tx, remat=True, compute_dtype=torch.bfloat16,
                               loss_chunk=256, layout=layout)
        (st, m), counts = counted(wrappers, lambda: step(
            TrainState(trainable, tx.init(trainable), 0), frozen, batch,
            torch.Generator().manual_seed(SEED + 64)))
        torch.cuda.synchronize(device)
        out.append((m, st.trainable, counts))
    (m0, t0, c0), (m1, t1, c1) = out
    summed = m1["loss_llm"].clone()
    dist.all_reduce(summed)
    dist.destroy_process_group()
    bad = _same_tree(t0, t1) + [k for k in ("loss_llm", "grad_norm")
                                if not torch.equal(m0[k], m1[k])]
    log(f"one rank over {backend} ({smi}): the 2-layer 7B-width Q-LoRA step with the process "
        f"group, loss {float(m1['loss_llm']):.6f}, grad_norm {float(m1['grad_norm']):.6f}; "
        f"{len(bad)} of loss, norm and updated leaves differ from the step without a group "
        f"(bit-equal demanded); launches { {k: n for k, n in c1.items() if n} } (without the "
        f"group the same: {c0 == c1}); the loss all-reduced over one rank {float(summed):.6f}")
    if backend != "nccl" or bad or not torch.equal(summed, m1["loss_llm"]):
        raise RuntimeError(f"one-rank NCCL step: backend {backend}, differs at {bad[:5]}, "
                           f"all-reduced loss {float(summed)}")
    if c0 != c1 or c1["flash_fwd_lse"] != 2 * 2 or not c1["nf4_dequant_planar"]:
        raise RuntimeError(f"one-rank NCCL step: launches {c1}, without the group {c0}")
    del params, frozen, trainable, out
    torch.cuda.empty_cache()
    return c1


def par_calibrate(smi, sharded=False):
    """``chip_smoke.py --par-calibrate``: the readings ``PAR_TOL`` is set
    from.  For each seed of ``PAR_CAL_SEEDS``: phase 22a's Q-LoRA run (7B
    from a snapshot written here, 4 steps of 8 x 1024) and phase 22b's
    X-Decoder run (2 steps of 8 at 512²), each in one process and on two
    ranks, and their worst relative gaps in loss and grad_norm (the sound
    readings); then at ``SEED`` the one-process run again (its own spread)
    and each fault of ``PAR_FAULTS`` on two ranks, its gaps from the
    one-process run (rank 0's; the ranks may disagree under a fault).
    ``sharded`` (``--par-calibrate sharded``): instead, for each seed the
    one-process runs and two ranks under ``MESH_FSDP: 2``, the Q-LoRA run
    under ``MESH_TENSOR: 2`` at ``SEED``, and each fault of ``SHARD_FAULTS``
    under ``MESH_FSDP: 2``.  Nothing is saved (a Q-LoRA run's saves write
    ~15 GB, and a call's disk writes are capped).  Logs each reading and
    prints one JSON line ``{"par_calibration": ...}``; a rank that fails
    fails the script."""
    import torch

    from cullavo_tpu_torch.models.llava.config import LlavaConfig
    from cullavo_tpu_torch.models.llava.modeling import init_llava_params
    from cullavo_tpu_torch.utils.constants import COCO_PANOPTIC_CLASSES

    device = torch.device("cuda", 0)
    readings = {"qlora": {}, "xtrain": {}}
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_cal_") as work:
        snap = os.path.join(work, "snapshot")
        os.makedirs(snap)
        cfg = LlavaConfig()
        params = init_llava_params(cfg, torch.Generator(device=device).manual_seed(SEED + 6),
                                   device, dtype=torch.bfloat16)
        write_snapshot(params, cfg, snap)
        del params
        torch.cuda.empty_cache()
        json_file, img_dir, pan_dir = write_panoptic_dataset(os.path.join(work, "coco"))
        dataset = {"KIND": "coco_panoptic", "JSON": json_file, "IMAGE_DIR": img_dir,
                   "PANOPTIC_DIR": pan_dir, "NUM_CLASSES": 133}
        spec = write_joint_dataset(os.path.join(work, "xtrain_data"), XDEC_SIZES,
                                   list(COCO_PANOPTIC_CLASSES), len(XDEC_THINGS), seed=SEED)
        over = {"DATASETS.TRAIN": [XTRAIN_DATASET], "DATASETS.REGISTER": {XTRAIN_DATASET: spec}}
        key = {"qlora": "loss_llm", "xtrain": "loss_total"}

        def run(path, seed, n, tag, fault=None, grid=None):
            grid = grid or ({"MESH_DATA": n} if n > 1 and path == "xtrain" else {})
            if path == "qlora":
                argv = qlora_argv(snap, dataset, seed=seed, grid=grid)
            else:
                argv = xtrain_argv(dict(over, **grid), seed=seed)
            return run_ranks(f"{path}_{tag}", [argv] * n, work, fault=fault)[1]

        def gap(path, tag, got, want, agree=True):
            k = key[path]
            row = {"loss": _rel([h[k] for h in got], [h[k] for h in want]),
                   "grad_norm": _rel([h["grad_norm"] for h in got],
                                     [h["grad_norm"] for h in want]), "ranks_agree": agree}
            readings[path][tag] = row
            log(f"par calibration {path} {tag} ({smi}): worst relative gap loss "
                f"{row['loss']:.3e}, grad_norm {row['grad_norm']:.3e}; ranks agree {agree}; "
                f"{got} against one process's {want}")

        for path in ("qlora", "xtrain") if sharded else ():
            one = {seed: run(path, seed, 1, f"one{seed}")[0]["history"]
                   for seed in PAR_CAL_SEEDS}
            fsdp = {"MESH_FSDP": PAR_RANKS}
            for seed in PAR_CAL_SEEDS:
                drv = run(path, seed, PAR_RANKS, f"fsdp{seed}", grid=fsdp)
                gap(path, f"fsdp_seed{seed}", drv[0]["history"], one[seed],
                    all(d["history"] == drv[0]["history"] for d in drv))
            if path == "qlora":
                drv = run(path, SEED, PAR_RANKS, "tensor", grid={"MESH_TENSOR": PAR_RANKS})
                gap(path, "tensor_seed0", drv[0]["history"], one[SEED],
                    all(d["history"] == drv[0]["history"] for d in drv))
            for fault in SHARD_FAULTS:
                drv = run(path, SEED, PAR_RANKS, fault, fault, grid=fsdp)
                gap(path, f"fsdp_{fault}", drv[0]["history"], one[SEED],
                    all(d["history"] == drv[0]["history"] for d in drv))
        for path in () if sharded else ("qlora", "xtrain"):
            one = {}
            for seed in PAR_CAL_SEEDS:
                one[seed] = run(path, seed, 1, f"one{seed}")[0]["history"]
                drv = run(path, seed, PAR_RANKS, f"seed{seed}")
                gap(path, f"seed{seed}", drv[0]["history"], one[seed],
                    all(d["history"] == drv[0]["history"] for d in drv))
            gap(path, "one_process_again", run(path, SEED, 1, "again")[0]["history"], one[SEED])
            for fault in PAR_FAULTS:
                drv = run(path, SEED, PAR_RANKS, fault, fault)
                gap(path, fault, drv[0]["history"], one[SEED],
                    all(d["history"] == drv[0]["history"] for d in drv))
    print(json.dumps({"par_calibration": readings, "tol": PAR_TOL, "device": smi}), flush=True)


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this "
                         "script runs only on a CUDA GPU")
    sys.path.insert(0, REPO)
    from cullavo_tpu_torch import _build
    from cullavo_tpu_torch.models.llava.config import LlavaConfig

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    t_start = time.perf_counter()

    def phase(name):
        log(f"== phase {name} at {time.perf_counter() - t_start:.1f} s")

    # phase 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    if "--par-calibrate" in argv:
        return par_calibrate(smi, sharded=argv[argv.index("--par-calibrate") + 1:][:1]
                             == ["sharded"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    phase(2)
    t0 = time.perf_counter()
    _build.lib()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
        f"(nvcc {_build.build_info['seconds']:.2f} s)")
    for line in _build.build_info["ptxas"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            log("  ptxas:", line.strip())
    sm90 = sm90_report()
    sources = {label: src for label, _, src in SM90_FORMS.values()}
    for name, row in sm90.items():
        log(f"Hopper kernel {name} ({sources[name]}): {row.get('registers')} "
            f"registers, {row.get('spill_store_bytes')} bytes spill stores, "
            f"{row.get('spill_load_bytes')} bytes spill loads, {row.get('stack_bytes')} bytes "
            f"stack; wgmma warnings: {row['warnings'] or 'none'}")
    if _build.build_info["ptxas"] != "(cached build)" and (
            len(sm90) != len(SM90_FORMS)
            or any(row.get("spill_store_bytes") or row.get("spill_load_bytes")
                   for row in sm90.values())):
        raise RuntimeError(f"Hopper kernels: an instantiation is missing or spills: {sm90}")

    phase(3)
    rec = check_kernels(device)
    for key, (label, forms, _) in SM90_FORMS.items():   # each instantiation's report
        for form in forms:
            if label in sm90:
                rec[form].setdefault("ptxas", {})[label] = sm90[label]
    wrappers = load_wrappers()
    meta = {"flash_fwd": ("cullavo_tpu_torch/csrc/flash_fwd_sm90.cu",
                          "cullavo_tpu/ops/flash_attention.py:259"),
            "quant_rows": ("cullavo_tpu_torch/csrc/quant_rows.cu",
                           "cullavo_tpu/ops/nf4.py:1157"),
            "int8_linear": ("cullavo_tpu_torch/csrc/nf4_gemv_sm90.cu",
                            "cullavo_tpu/ops/nf4.py:912"),
            "wwin_decode": ("cullavo_tpu_torch/csrc/wwin_decode_sm90.cu",
                            "cullavo_tpu/ops/wwin_decode.py:52"),
            "wwin_decode_q8": ("cullavo_tpu_torch/csrc/wwin_decode_sm90.cu",
                               "cullavo_tpu/ops/wwin_decode.py:104"),
            "nf4_linear_planar": ("cullavo_tpu_torch/csrc/nf4_gemv_sm90.cu",
                                  "cullavo_tpu/ops/nf4.py:627"),
            "nf4_dequant_planar": ("cullavo_tpu_torch/csrc/nf4_planar.cu",
                                   "cullavo_tpu/ops/nf4.py:729"),
            "flash_fwd_lse": ("cullavo_tpu_torch/csrc/flash_fwd_sm90.cu",
                              "cullavo_tpu/ops/flash_attention.py:259"),
            "flash_rows": ("cullavo_tpu_torch/csrc/flash_fwd_sm90.cu",
                           "cullavo_tpu/ops/flash_attention.py:142"),
            "ms_deform_attn": ("cullavo_tpu_torch/csrc/msdeform.cu",
                               "cullavo_tpu/ops/msdeform_pallas.py:43"),
            "focal_ctx": ("cullavo_tpu_torch/csrc/focal_ctx.cu",
                          "cullavo_tpu/ops/focal_pallas.py:34"),
            # K11 replaces row 9 and, fed the decoded absmax, row 8
            # (cullavo_tpu/ops/nf4.py:222, nf4_matmul_fused); its dequant
            # entry serves row 9's prefill M
            "nf4_linear_q4": ("cullavo_tpu_torch/csrc/nf4_gemv_sm90.cu",
                              "cullavo_tpu/ops/nf4.py:464"),
            "nf4_dequant_q4": ("cullavo_tpu_torch/csrc/nf4_q4.cu",
                               "cullavo_tpu/ops/nf4.py:464"),
            # K12: row 5's decode kernel in the general form the zoo's
            # stale-cache decode needs (cullavo_tpu/models/llava/llama.py:174)
            "flash_decode": ("cullavo_tpu_torch/csrc/flash_decode.cu",
                             "cullavo_tpu/ops/flash_attention.py:687"),
            # K13: row 4's _fwd_kernel_iota_packed and, the same function in
            # another TPU tiling, row 3 (_fwd_kernel_iota in batch groups, :596)
            "flash_packed": ("cullavo_tpu_torch/csrc/flash_fwd_sm90.cu",
                             "cullavo_tpu/ops/flash_attention.py:623"),
            "p32_linear": ("cullavo_tpu_torch/csrc/nf4_gemv_sm90.cu",
                           "scripts/matmul_probe.py:154")}

    phase("4-6c")
    cfg = LlavaConfig()
    t0 = time.perf_counter()
    params = build_params(cfg, device)
    log(f"7B params built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated")
    reference_check(params, cfg, device)
    requests = make_requests(cfg, device)
    counts, run_greedy = run_greedy_path(params, cfg, device, requests, wrappers)
    counts_spec, run_spec = run_spec_path(params, cfg, device, requests, wrappers)
    # phase 6c
    run_packed_prefill(params, cfg, device, requests, wrappers)
    if "--profile" not in argv:   # the profiled batches at the end need the int8 model
        del params, run_greedy, run_spec
        torch.cuda.empty_cache()

    phase("7 and 18")
    serve_smoke(device)
    t0 = time.perf_counter()
    params_nf4 = build_nf4_params(cfg, device)
    log(f"7B params with the NF4 base built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated(device) / 2**30:.2f} GiB allocated")
    reference_check_nf4(params_nf4, cfg, device)
    counts_serve, run_serve = run_serving_path(params_nf4, cfg, device, wrappers)
    # phase 18 (phase 7's NF4 parameters)
    counts_http, profile_adapters = run_serving_rest(params_nf4, cfg, device, wrappers, smi,
                                                     profile="--profile" in argv)

    phase("8 and 8b")
    train_smoke(device)
    reference_check_train(params_nf4, cfg, device)
    counts_train, train_pipe, train_batch = run_train_path(params_nf4, cfg, device, wrappers)
    counts_probe = run_attn_probe(device, wrappers)
    if "--profile" not in argv:
        del params_nf4, train_pipe, train_batch, run_serve
        torch.cuda.empty_cache()

    phase(9)
    xdecoder_entry_smoke(device)
    reference_check_xdecoder(device, wrappers)
    counts_focal, focal_pipe, xdec_rows = run_xdecoder_path(XDEC_FOCAL, device, wrappers, smi)
    counts_deform, _, _ = run_xdecoder_path(XDEC_DEFORM, device, wrappers, smi)
    if "--profile" not in argv:
        del focal_pipe, xdec_rows
        torch.cuda.empty_cache()

    # phases 10-13 share a working directory: phase 10's snapshot is phase 12's
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_") as work:
        snap = os.path.join(work, "snapshot")
        os.makedirs(snap)
        phase("10 and 10b")
        counts_vl, params_vl = run_vl_snapshot_path(cfg, device, wrappers, smi, snap)
        counts_q4 = run_q4_path(params_vl, cfg, device, requests, wrappers, smi)
        del params_vl
        torch.cuda.empty_cache()

        phase(11)
        zoo_entry_smoke(device, wrappers)
        reference_check_zoo(device, wrappers)
        counts_zoo = run_zoo_path(device, wrappers, smi, "--profile" in argv)
        torch.cuda.empty_cache()

        phase(12)
        counts_loop, loop_ref = run_train_loop_path(snap, cfg, device, wrappers, smi, work)
        shutil.rmtree(os.path.join(work, "step1_out"))   # the later phases write their own
        torch.cuda.empty_cache()
        # phase 22a: phase 12's run 1 on two ranks
        phase("22a")
        par_train = run_parallel_train_path(snap, smi, work, loop_ref)
        # phase 23a-b: the same under MESH_FSDP 2 and MESH_TENSOR 2
        phase("23a-b")
        shard_train = run_sharded_train_path(snap, smi, work, loop_ref, par_train)

        phase(14)
        counts_step2 = run_step2_pre_path(snap, device, wrappers, smi, work)
        torch.cuda.empty_cache()
        phase("22c")
        par_step2 = run_parallel_step2_path(snap, smi, work, cfg.text.num_hidden_layers)
    phase("22d")
    par_nccl = run_nccl_step(device, smi, wrappers)

    phase(13)
    counts_probe13 = run_matmul_probe(device, wrappers)
    phase(15)
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_xtrain_") as work:
        counts_xtrain, xtrain_ref = run_xtrain_path(device, wrappers, smi, work, rec)
        # phase 22b: phase 15's entry.train on two ranks
        phase("22b")
        par_xtrain = run_parallel_xtrain_path(work, smi, xtrain_ref, rec)
        # phase 23c: the same under MESH_FSDP 2
        phase("23c")
        shard_xtrain = run_sharded_xtrain_path(work, smi, xtrain_ref)
        # phase 16 (its train -> eval step reads phase 15's checkpoint)
        phase(16)
        counts_xeval, pt_focal = run_xeval_path(device, wrappers, smi, work, rec)
        # phase 17 (phase 16's checkpoint and CLIP files)
        phase(17)
        counts_vlp = run_vlp_path(device, wrappers, smi, work, rec, pt_focal)
    torch.cuda.empty_cache()
    # phase 19: InstructBLIP and the ImageNet eval on its towers, then the
    # topic classifier
    phase(19)
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_zoo_rest_") as work:
        counts_ib = run_instructblip_path(device, wrappers, smi, work, "--profile" in argv)
    counts_topic = run_topic_path(device, wrappers, smi, "--profile" in argv)
    # phase 20: BakLLaVA and the zoo's other towers from snapshots written here
    phase(20)
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_zoo_path_") as work:
        counts_bak = run_bakllava_path(device, wrappers, smi, work)
        counts_zoo_path = run_zoo_snapshot_path(device, wrappers, smi, work)
    torch.cuda.empty_cache()
    # phase 21: BLIP-2 OPT at full width and depth, then from a snapshot
    phase(21)
    with tempfile.TemporaryDirectory(prefix="cullavo_chip_opt_") as work:
        counts_opt, counts_opt_snap = run_opt_path(device, wrappers, smi, work,
                                                   "--profile" in argv)
    torch.cuda.empty_cache()
    phase("end of the paths")
    # each kernel's launches on the main path that runs it: K1-K4 the greedy
    # bf16-cache batch, K5 the speculative int8-cache batch, K6 and K7 the
    # serving run, K1-lse the train steps, K8 the attention probe, K9 the
    # SAM-ViT-B + deformable eval, K10 the FocalNet-L + FPN eval
    counts["wwin_decode_q8"] = counts_spec["wwin_decode_q8"]
    for name in ("nf4_linear_planar", "nf4_dequant_planar"):
        counts[name] = counts_serve[name]
    counts["flash_fwd_lse"] = counts_train["flash_fwd_lse"]
    counts["flash_rows"] = counts_probe["flash_rows"]
    counts["focal_ctx"] = counts_focal["focal_ctx"]
    counts["ms_deform_attn"] = counts_deform["ms_deform_attn"]
    for name in ("nf4_linear_q4", "nf4_dequant_q4"):
        counts[name] = counts_q4[name]
    # K12: the two zoo models' first runs of phase 11, each counted from 0
    counts["flash_decode"] = sum(counts_zoo.values())
    # K13: phase 12's packed training run; K14: phase 13's probe
    counts["flash_packed"] = counts_loop["flash_packed"]
    counts["p32_linear"] = counts_probe13["p32_linear"]
    log(f"launches on the vl_test path (BITS 8 from the snapshot): {counts_vl}")
    log(f"K7 launches on the train path: {counts_train['nf4_dequant_planar']}")
    if not all(counts.values()):
        raise RuntimeError(f"a kernel never launched on its main path: {counts}")
    if "--profile" in argv:   # last: an attached profiler slows every later launch
        profile_xdecoder(focal_pipe, xdec_rows, device)
        profile_train(train_pipe, train_batch, device)
        profile_serving(run_serve)
        profile_adapters()
        profile_path("greedy bf16-cache", run_greedy)
        profile_path("speculative int8-cache", run_spec)

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1], "launches": counts[name],
                **{k: rec[name][k] for k in keys}}
               for name in wrappers]
    for k in kernels:
        # the other forms' times on the same inputs, times in turns, host
        # time per call, extra shapes, ptxas
        for extra in ("k13_same_inputs_ms", "k1_same_inputs_ms", "times_in_turns", "host_us",
                      "loop_shape", "prefill_shape", "ptxas", "zoo_shapes", "other_shapes",
                      "bakllava_shape",
                      "train_shape", "train_fwd_ms", "plain_backward_ms",
                      "plain_backward_bound", "xdecoder_train", "xdecoder_eval", "vlp_224",
                      "vlp_eval"):
            if extra in rec[k["name"]]:
                k[extra] = rec[k["name"]][extra]
        if k["name"] == "nf4_linear_q4":
            k["also_replaces"] = "cullavo_tpu/ops/nf4.py:222"
        if k["name"] == "flash_packed":
            k["also_replaces"] = "cullavo_tpu/ops/flash_attention.py:596"
        if k["name"] in ("flash_fwd", "wwin_decode"):   # phase 14's entry.main run
            k["step2_pre_launches"] = counts_step2[k["name"]]
        k["xdecoder_train_launches"] = counts_xtrain[k["name"]]   # phase 15's entry.train
        k["xdecoder_eval_launches"] = counts_xeval[k["name"]]     # phase 16's entry.evaluate
        k["vlp_eval_launches"] = counts_vlp[k["name"]]            # phase 17's entry.evaluate
        k["serve_http_launches"] = counts_http[k["name"]]         # phase 18's HTTP run
        # phase 19: InstructBLIP's 8 questions and the topic classifier's
        k["vl_zoo_rest_launches"] = counts_ib[k["name"]] + counts_topic[k["name"]]
        # phase 20: BakLLaVA's 8 questions and the three zoo snapshots' 8 each
        k["vl_zoo_path_launches"] = counts_bak[k["name"]] + counts_zoo_path.get(k["name"], 0)
        # phase 21: BLIP-2 OPT-2.7b's 8 questions and the cut snapshot's 8
        k["vl_zoo_opt_launches"] = counts_opt[k["name"]] + counts_opt_snap[k["name"]]
        # phase 22: each rank's launches (22a-c, other processes) and 22d's
        k["two_rank_launches"] = {
            "qlora": [c[k["name"]] for c in par_train["launches"]],
            "xdecoder_train": [c[k["name"]] for c in par_xtrain["launches"]],
            "step2_pre": [c[k["name"]] for c in par_step2],
            "nccl_one_rank_step": par_nccl[k["name"]]}
        # phase 23: each rank's launches under MESH_FSDP 2 / MESH_TENSOR 2
        k["sharded_launches"] = {
            "qlora_fsdp": [c[k["name"]] for c in shard_train["fsdp"]["launches"]],
            "qlora_tensor": [c[k["name"]] for c in shard_train["tensor"]["launches"]],
            "xdecoder_train_fsdp": [c[k["name"]] for c in shard_xtrain["launches"]]}
    log(f"two ranks: Q-LoRA {par_train}; X-Decoder {par_xtrain}")
    log(f"two ranks, sharded: Q-LoRA {shard_train}; X-Decoder {shard_xtrain}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(sys.argv[2:])
    else:
        main(sys.argv[1:])
