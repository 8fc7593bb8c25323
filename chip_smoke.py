"""Smoke run of the PyTorch port (reftr_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Print the card's name and power limit, then build every kernel of the
   serving and training paths from the sources in this checkout
   (reftr_torch/kernels/csrc/flash_attn_fwd.cu, flash_attn_fwd_tc.cu,
   flash_attn_fwd_wg.cu, flash_attn_fwd_f32tc.cu, flash_attn_fwd_dec.cu,
   flash_attn_bwd.cu, flash_attn_bwd_dq_tc.cu, flash_attn_bwd_dq_wg.cu,
   flash_attn_bwd_dkv_tc.cu, flash_attn_bwd_dkv_wg.cu,
   flash_attn_bwd_dq_f32tc.cu, flash_attn_bwd_dkv_f32tc.cu and
   flash_attn_bwd_dec.cu, one nvcc each for sm_90a, started together with
   one g++ of the data pipeline's C++ under reftr_torch/data/csrc/), and
   count the tensor-core products in the machine code (cuobjdump -sass):
   HMMA in the six mma.sync kernels, bf16 and 3xTF32, HGMMA (wgmma) in
   the three warpgroup kernels; none fails the run. Print the D=32
   function's opcode counts and ptxas lines (registers, spills) of every
   tensor-core kernel, the dropout draw's callers among them. Read what
   the bound needs: the SM count, the SM clock nvidia-smi gives as its
   maximum, and the IMADs of a Philox call in K1-wg's machine code.
2. The forward kernel (K1) against its plain PyTorch version on the card,
   at the four call sites of the refcoco_det forward (B=8), with random key
   padding and one row whose keys are all masked, in float32 and bfloat16,
   each against the plain version in float32 on the same inputs, through
   the variant the dispatch rule picks (attention.fwd_variant: fewer than
   16 queries on the decode kernel; with more, the tensor cores, bf16 in
   bf16 and float32 by 3xTF32). The SIMT kernel, which the rule no longer
   picks, is checked beside each, and timed as the same-run "before" at
   the decoder's cross-attention in bf16 alone (simt_timed), where the
   kernels line reads it.
   Tolerances: 1e-5 max abs in float32 (the sums run in another order),
   2e-2 in bfloat16 (the kernel rounds its output to bf16: half a bf16
   ulp is 7.8e-3 at magnitudes up to 4). Times of the kernel, the plain version and
   F.scaled_dot_product_attention (a yardstick only; the port never calls
   it): "ms" with CUDA events around 50 back-to-back calls after a warm-up
   (which includes the host's time per call where that exceeds the
   kernel's), "device_ms" as the device activities torch.profiler records
   per call.
3. The training kernels at the same call sites and inputs, in float32 and
   bfloat16, without dropout and with rate 0.1, each through the variant
   the rule picks (attention.dq_variant for K2, dkv_variant for K3: below
   16 queries one launch of the decode backward gives dq, dk and dv; with
   more, the tensor-core kernels, in float32 the 3xTF32 ones), and the
   SIMT kernels beside the others: K1 with dropout and its lse against
   attention_plain in float32 with the same seed (tolerances as in phase
   2; lse 1e-5 abs plus 1e-6 relative), and the backward
   kernels K2 (dq) and K3 (dk, dv) each against attention_bwd_plain on
   the same O, lse and dO. Every
   variant, K1's and the backward's, is called twice on the same inputs
   and must give the same bits.
   Gradient tolerance, as a share of the largest magnitude among the plain
   dq, dk and dv: 1e-4 in float32 (sums of up to 440 terms in another
   order, at most 2.6e-5 of the largest term), 1e-2 in bfloat16 (the
   kernels round their output to bf16, 2^-9 = 2e-3). K1 in bf16 here and
   in phase 8: 2e-2 of the largest plain output, at most 2e-2, and at
   phrase BERT one bf16 ulp of the largest output where that is more
   (kernel_tol). Then exact mask
   checks in float32 and in bfloat16 at every site (so through every
   variant of K1, K2 and K3): v one-hot over the head dim makes K1's
   output p * keep for D keys at a time; q = 0, lse = 0, O = 0 and dO, v
   one-hot on the first head dim make K2's ds the keep multiplier of each
   valid key, and k one-hot over the head dim reads it off dq for D keys
   at a time; q = 0 makes p uniform over the valid keys, and dO one-hot
   over the head dim for D queries at a time (zero for the others) makes
   K3's dv_j[d] = p * keep(i0 + d, j). The kept set must equal the plain
   Philox mask on every key with p > 0. Times (host loop and device) of
   each kernel (the SIMT K1 and K2 as in phase 2: at the decoder's
   cross-attention in bf16 alone), its plain version, its bound and the
   yardsticks: SDPA's
   forward, and its backward, which covers K2 and K3 together. The bound
   reckons float32 products at the 165 TFLOP/s of float32-accurate
   products that 3xTF32 gets from the tensor cores, and takes the largest
   of the bytes, the products, one MUFU.EX2 a (query, key) pair at 16 a
   clock per SM and, with dropout, a quarter of a Philox call a pair at 64
   IMADs a clock per SM (attention_bound_terms). Where the rule sends K1,
   K2 or K3 to a warpgroup kernel ("wg"), the mma.sync kernel ("tc") is
   checked and timed beside it, the same-run "before"; K3-wg alone
   computes di = rowsum(dO * O) in its wrapper (K2 gives it in a step),
   and is timed on a di computed before the timed calls.
   Then head dims off the kernels' instances (HEAD_DIM_SWEEP: 8, 24, 48
   and 96 pad to the next of 16, 32, 64, 128; 160 and 256 take the plain
   versions by the rule), in both dtypes with and without dropout, K1, K2
   and K3 through the rule against the plain versions at the same
   tolerances; a plain call must launch nothing and count in
   launches_plain, which is printed. Then K3's SIMT route, K3 with 16 or
   more queries and fewer than 16 keys, which no call site of the model
   reaches: B=8, Sq=440, Sk=8, H=8, D=32 in both dtypes, with and without
   dropout, against attention_bwd_plain, with its bound, the plain time
   and SDPA's backward.
   3d. The warpgroup kernels against the mma.sync ones and SDPA in one
   process (wg_times), in bf16 without dropout and with 0.1, at the VL
   encoder at 1-4 feature levels (440^2, 2040^2, 8440^2 and 8540^2, B=8;
   at four levels also with each image padded), flickr's at 1 and 2
   (490^2 and 2090^2, B=16) and flickr's decoder over 490 keys: K1 "tc",
   "wg" and SDPA's forward; K2 "tc" and "wg", K3 "tc" and "wg" against
   SDPA's backward; CUDA events, in turns, the median of three. "wg" is
   checked against the plain version at phase 3's tolerances (K2-wg's dq
   at 1e-2 of the largest plain gradient in bf16, its di against
   di_plain, its bits on a repeated call): on all the inputs where its
   scores fit, else on batch row 0 (B=1).
   3e. The dropout draw of K1 and K2 (flash_tc::keep_bits) exact in every
   kernel that calls it, K1 "tc", "wg", "tf32x3" and K2 "tc", "wg",
   "tf32x3", each launched directly (check_keep_bits): at key counts that
   are not a multiple of 4, even (22, 90, 490, 2090: row phases 0 and 2)
   and odd (17, 131, 385: every phase), and in bf16 in the last batch row
   of B=8 at 8539^2, whose element offsets run past 2^32.
4. The serving path at full width: refcoco_det (ResNet-50, BERT-base,
   6+6 VL layers, d=256) at 640x640 with seeded random weights, bfloat16,
   behind a MicroBatcher with serve batch 8. Six requests of 1-3 phrases
   each (random uint8 canvases with ragged valid regions, token ids of
   length 5-40). Every request must come back without error, with finite
   boxes inside its image, and K1's launch count must rise by exactly 30
   per batch forward (12 BERT + 6 encoder + 12 decoder attentions), 18 of
   them (BERT and encoder) through the tensor-core kernel and 12 (the
   decoder) through the decode kernel, K2's and K3's not at all. Then full
   batches time the forward (host to host, median of four turns each with
   the kernel and with the plain attention, after a warm-up), and
   torch.profiler splits one forward's device time by kernel category.
   The same six requests are then served by the float32 model (30 K1
   launches per forward again: 18 on the 3xTF32 kernel, 12 on the decode
   kernel), full float32 batches time the forward as the bf16 ones, in
   turns with K1 on the 3xTF32 kernel and with K1 sent to SIMT (the
   same-run "before"), and torch.profiler profiles one forward of each;
   then one padded batch runs through the kernel
   and through the plain attention on the card and the encoder memory and
   decoder states are compared: float32 kernel against float32 plain at
   1e-4 max abs (the per-attention 1e-6 gap carried through 30 attentions
   and their LayerNorms), bfloat16 kernel against bfloat16 plain and
   against float32 plain at 5e-2 relative L2 error (bf16 rounding of every
   activation of a 100-layer network).
5. The training path at full width: the same model with float32
   parameters under bfloat16 autocast, dropout 0.1, AdamW in the four LR
   groups with the clip at 0.1, batch 8 of seeded random canvases, token
   ids and boxes, through train_one_epoch over 20 steps of that one batch.
   Every loss and gradient norm must be finite, the mean loss of the last
   3 steps below that of the first 3 (a memorised batch), and each of K1,
   K2 and K3 launched exactly 30 times per step, 18 of each (BERT and
   encoder) through the tensor-core kernels (the encoder's 6 of K3 on its
   warpgroup kernel, by the rule) and the other 12 of each (the decoder)
   through the decode kernels (K2's and K3's 12 are the decode
   backward's 12 launches, each counted on both): none through the SIMT
   kernels. It reports the median
   host-to-host step time after 3 warm-up steps, the peak device memory
   and one step's device time by kernel category, and the step time by
   the rule and with the encoder's K3 on "tc", in turns (k3_route_steps).
   Then one float32 step
   with dropout 0 from one set of weights through the kernels and through
   the plain attention: the loss within 1e-5 relative, and every trainable
   gradient within 1e-3 relative L2 of the plain path's, measured against
   the larger of its norm and 1e-4 of the global gradient norm (gradients
   that are zero in exact arithmetic, a key bias's or the decoder's 1x1
   self-attention's q and k, come out at rounding level on both paths).
   The last layer of the box head is drawn like the other layers for this
   step: at init it is zero and no gradient would reach the attentions.
   The float32 step's K1, K2 and K3 run on the 3xTF32 kernels (BERT and
   encoder) and the decode kernels. Then a timed float32 training run:
   the same model with float32 parameters and compute (no autocast),
   dropout 0.1, 8 steps through train_one_epoch: finite losses, 30
   launches of each of K1, K2 and K3 per step, 18 of each on the 3xTF32
   kernels and 12 on the decode kernels, none on SIMT; the median host
   step after 3 warm-up steps, one step's device time by category with
   the attention kernels' share, and the same step profiled with K1, K2
   and K3 on the SIMT kernels, as the rule sent them before the 3xTF32
   kernels (the same-run "before").
6. The trainer's entry point: reftr_torch.cli.main.main(argv), called in
   this process, on refcoco_det at full width and depth in float32 (the
   preset has no dtype; the command line's default is bfloat16, so
   --dtype float32 is passed) on the synthetic fixture: 64 train items
   and the fixed 64-item val split at 640 px, batch 8, 4 loader threads,
   output in chiprun_out/cli (emptied first). Three runs: epoch 0 of 2
   (--run_epoch 1 --auto_resume: 8 train steps, 8 eval batches,
   checkpoints), the same command again (it must auto-resume at epoch 1,
   step 8, and train epoch 1), and --eval --resume of the saved
   checkpoint. Checks: exit code 0 each; log.txt's two lines with every
   loss finite; checkpoint and the val result file written;
   checkpoint_best present exactly when an epoch's accuracy_iou0.5 rose
   above 0 (the best starts at 0); the eval-only accuracy_iou0.5 equal to
   the epoch-1 line's and its miou within 1e-5; each run's launches
   exactly 30 of each of K1, K2 and K3 per train step and 30 of K1 per
   eval batch (18 on the 3xTF32 kernels, 12 on the decode kernels, none
   on SIMT or plain). Reports, beside the card's name and power limit,
   the seconds per train step and per eval batch host to host, the mean
   time: and data: of a step (core/metrics.py::log_every), the model's
   build time, each checkpoint's bytes and save time and the peak device
   memory of each run. The checkpoints but "checkpoint" are then deleted
   (their sizes are reported), so chiprun_out/ stays small; phase 7
   starts from "checkpoint" and deletes it.
7. RES: refcoco_seg (phase 6's model with the mask head over the
   backbone's C3, C2 and C1, logits at 160 x 160) at full width on the
   synthetic fixture, whose masks are the boxes' rectangles. a) The CLI's
   default bf16: main(argv) fine-tunes from phase 6's checkpoint
   (--pretrained_model) for one epoch of 8 steps and 8 eval batches into
   chiprun_out/res, then --eval --resume evaluates its checkpoint. Checks:
   exit codes 0; the missing-key report names only bbox_attention.* and
   mask_head.*, with nothing unexpected; every logged loss finite,
   loss_mask and loss_dice included; seg_miou in [0, 1]; the eval-only
   accuracy equal to the log's, miou and seg_miou within 1e-5; launches
   exactly 30 of each kernel a step (18 on the bf16 tensor-core kernels,
   12 on the decode kernels) and 30 of K1 an eval batch. b) Float32
   freeze_reftr with the CEM loss from the fine-tuned weights, 4 steps
   through train_one_epoch: K1 30 a step, K2 and K3 never; every trunk
   tensor keeps its bytes; every head tensor with a gradient moves, in
   each of bbox_attention, mask_head and cem_block; loss_cem finite.
   c) One float32 step (dropout 0) from seeded weights through the
   kernels and through the plain attention: the loss within 1e-5
   relative, every gradient within 1e-3 relative L2 (phase 5's rule),
   pred_boxes within 1e-4 max abs and pred_masks within 1e-4 relative L2.
   d) Report only: a bf16 RES step's host time after a warm-up, its peak
   memory and its device time by kernel category, the mask head's
   convolutions at 160 x 160 on a row of their own (told apart by their
   weight shapes in the profile's recorded shapes). e) Phase 4's six
   requests through a MicroBatcher over the fine-tuned RES model in bf16
   and float32: every request answered with a finite box inside its image
   and a mask of its original size; K1 30 a batch. Beside the card's
   name and power limit, the fine-tune's and eval's seconds per step and
   batch, time: and data:, and peak memory are printed. The checkpoints
   are deleted.
8. Multi-phrase, four feature levels and RoBERTa. a) The entry point on
   the flickr preset at full width (BERT-base over the sentence and over
   16 phrase slots of 22 tokens, 90 sentence tokens, 6+6 VL layers, d=256,
   batch 16 at 640 px) in the CLI's default bf16 on the multi-phrase
   fixture (--dataset synthetic_multi, the port's name of the JAX
   package's SyntheticMultiPhraseDataset: each sentence names two
   rectangles): one epoch of 8 steps and the fixture's 64 eval items (4
   batches) into chiprun_out/multi, then --eval --resume. Checks: exit
   codes 0; every logged loss finite; the eval-only accuracy equal to the
   log's, its miou within 1e-5; two boxes per eval item in the result
   file; launches exactly 42 of each kernel a step and of K1 an eval batch
   (12 BERT over the sentence + 12 over the phrases + 6 encoder + 6 + 6
   decoder at 16 phrase queries), all on the bf16 tensor-core kernels.
   b) K1, K2 and K3 against their plain versions at the sites this path
   adds (BERT over 256 phrases of 22 tokens, H=12, D=64, with "[CLS]
   [SEP]" in 14 of each image's 16 rows; the decoder's self-attention
   16 x 16 with 2 real phrases and its cross-attention 16 x 490; the
   encoder 490 x 490), in both dtypes, with and without dropout, with
   phase 3's tolerances, exact dropout masks and times (no SIMT
   "before"). c) One float32 multi-phrase step (batch 16 of the fixture)
   through the kernels and through the plain attention at phase 5's rule,
   and (report only) each path's distance from the plain attention in
   float64; one bf16 step timed and profiled by kernel category (report
   only).
   d) refcoco_det at four feature levels (the encoder over 40 + 80^2 +
   40^2 + 20^2 + 10^2 = 8540 tokens) through the entry point in bf16: 4
   steps and 8 eval batches, 30 launches of each kernel a step and of K1
   an eval batch (18 on the tensor cores, of which the encoder's 6 of
   K1, K2 and K3 on the warpgroup kernels, 12 on the decode kernels); one
   profiled bf16 step with its device time and attention share (the step
   with K2, or K1-K3, on their mma.sync kernels, the warpgroup kernels'
   old same-run "before"s, is not timed); K1, K2 and K3 against
   their plain versions at the encoder at B=1 (the plain version's
   [B, H, S, S] scores fit there) in both dtypes with exact masks; the
   masks of K1, K2 and K3 exact in the last batch row at B=8, whose
   element offsets run past 2^32; the float32 kernels' times at B=8
   against SDPA and the bound (bf16's are phase 3d's). e) flickr_roberta
   (RoBERTa-base's widths: vocabulary 50265, 514 positions, pad id 1) on
   the fixture through the entry point over a byte-level vocabulary the
   script writes: 2 steps and 4 eval batches, 42 launches of each kernel
   a step, every loss finite. The checkpoints are deleted. f) Report only
   (float64_gap): the float32 kernels' and the plain float32 version's
   distance from float64 at 440, 2000 and 8540 keys, K1's sum alone
   (q = 0) there, the bf16 kernels' sums there (K1's sum alone, K2's dq
   sum and K3's dV sum, "tc" and "wg" beside the plain bf16 version), and
   phrase BERT's bf16 outputs against float64.
9. Data-parallel training (DDP), each part in processes that
   ``python -m reftr_torch.tools.launch`` starts, which run this script
   with a child's name (``CHILDREN``): a) refcoco_det at full width in
   bf16 (dropout 0.1) through ``reftr_torch.cli.main`` under the launcher,
   one rank on cuda:0 over NCCL (a group of one): 8 steps and one eval of
   8 batches; the rank reports torch.distributed's backend and world
   size, every logged loss finite, the launches of each kernel (counts
   set to 0 just before and read just after the run, in the rank) as
   phase 5's rule counts them, 30 a step and 30 of K1 an eval batch, and
   log.txt and the checkpoint written once (the checkpoint is deleted).
   b) Two gloo ranks on the one card (NCCL refuses two ranks on one
   device; each starts its group itself, which ``initialize`` leaves
   alone), float32: at dropout 0 one DDP step of the ranks on the two
   halves of phase 5's batch against one process on the whole batch (the
   loss, the mean of the ranks', and the gradient norm within 1e-5
   relative, every gradient within 1e-3 relative L2, phase 5's rule; the
   updated parameters as tests/test_torch_train.py holds them: 1e-6
   absolute where the clipped gradient is above 100 Adam eps, elsewhere
   2 lr, since Adam's first update follows the sign of a gradient at
   rounding level); at dropout 0.1 both ranks on the same
   half: every K1 output over more than one key differs between the
   ranks, and rank 0's equal bit for bit those of one process drawing
   from the same generator state. c) Report only: one NCCL rank times
   phase 5's bf16 step without DDP and under DDP in turns (host ms with
   the metrics read back each step), profiles each once (device ms, the
   NCCL all-reduce's device ms) and reads the peak memory.
10. The repo's from-scratch recipe (exps/run_gn_flagship3.sh without its
   TPU stem): refcoco_det's geometry at full width with BERT-tiny,
   GroupNorm in the backbone, the stem and layer1 trained, pre-norm, the
   vision probe and its loss, lr 3e-3. a) Through
   ``reftr_torch.cli.main`` in bf16: two epochs of 8 steps (batch 16) of
   its 120-epoch schedule, then --eval --resume, whose accuracy must
   equal the log's; every logged loss finite; 20 launches of each kernel
   a step and of K1 an eval batch (8 on the tensor-core kernels, 12 on
   the decode kernels); a profiled step (host and device ms, busy share,
   peak memory, the copy kernels' ms) with GroupNorm and with FrozenBN.
   b) The overflow guard: 20 bf16 steps on one repeated batch at the
   recipe's LR held constant: every loss finite, phase 5's health rule,
   layer4's largest magnitude below 1e4 at every step; with FrozenBN
   beside it, report only. c) One float32 step with all seven options
   (also --img_pos_in_stream, --decoder_pos_in_value, --heatmap_box),
   kernels against the plain attention at phase 5's rule over every
   trainable tensor, the stem's, layer1's, the GroupNorms' and the
   probe's among them. d) Phase 4's six requests served from a's
   checkpoint with --heatmap_box in bf16: no error, every box a cxcywh
   inside [0, 1] of its image, 20 launches of K1 a batch.
11. A reference checkpoint served over HTTP. First K1 (out and lse), K2
   and K3 against their plain versions at the server's batch of 16 where
   no earlier phase checks that shape (BERT-base over 40 tokens, the
   decoder's self- and cross-attention; the encoder's 440^2 at B=16 is
   phase 10's), in both dtypes, without dropout and with 0.1, at phase
   3's tolerances, the dropout masks exact, the bf16 calls timed.
   a) refcoco_det's seeded
   weights at full width (the box head's last layer drawn, so the boxes
   move with the input) written under the reference's names as a float32
   .pth (main_vg.py's {"model", "optimizer", "lr_scheduler", "epoch",
   "args"}, module.-prefixed; nn/convert.py::save_reference_checkpoint,
   the one copy of the name map the CPU tests share), named with its
   sha256 fragment, served by a http.server on 127.0.0.1 and loaded by
   URL through core/hub.py (REFTR_CACHE_DIR a temporary directory) into a
   fresh model, then again from the cache: every tensor equal to the
   source bit for bit, nothing missing or unexpected, one download;
   bytes, download, sha256 and convert-and-load seconds printed.
   b) tools/serve.build_server in this process, serve batch 16, 5 ms,
   weights from that URL, bf16: 64 POST /predict of 1-3 phrases on random
   images of 480x640, 427x640, 640x480 and 375x500, from one client in
   sequence and then from 16 at once, and 16 to a float32 server. Every
   answer 200 with finite boxes inside their image, each within 1e-3
   (bf16) or 1e-4 (float32) of the image's side of the same rows run
   straight through the server's ServingModel on canvases the smoke
   builds, and the phrases of one request at least that far apart in
   the median (so a swap of rows would show); /healthz and /stats
   (requests and rows as sent); K1 exactly 30 launches a batch (18 tc or
   tf32x3, 12 dec), K2 and K3 none; 17 phrases answer 500, none 400, an
   unknown path 404. Per load: requests and rows a second, p50 and p99
   latency, mean_batch_fill, batches and the host ms of
   Frontend.preprocess a request. Images travel as .npy bytes:
   tools/serve.decode_image is swapped for a .npy reader (the card's
   machine has no PIL or cv2), and nothing else. c)
   reftr_torch.cli.predict.main with the .pth path on two of b)'s images
   (data/datasets._load_image a .npy reader): each phrase's box within
   1e-3 of the side of b)'s answer, 30 launches of K1 a call.
12. The exported serving forward (reftr_torch/tools/export_model.py), on
   phase 11's .pth and in its temporary directory. a) refcoco_det at full
   width exported at the server's batch of 16 on the card, in bf16 and in
   float32: the model built and the .pth loaded, torch.export, save
   and load seconds and the artefact's bytes. b) The loaded program in a
   ServingModel (``exported_dir``) against the live ServingModel of the
   same .pth on two serve batches of 11b's requests: pred_boxes within
   1e-5 max abs in float32 (JAX's --selfcheck limit) and 1e-3 in bf16
   (phase 11's); K1 exactly 30 launches a batch through the program by
   the rule (18 tc or tf32x3, 12 dec), K2, K3 and plain none; every call
   of the op (torch.ops.reftr.flash_attention_fwd) in one batch recorded
   by a dispatch mode, and its outputs' shapes, strides and dtypes equal
   to the op's fake's on the same inputs. c) tools/serve.build_server
   with ``exported_dir`` on the bf16 artefact, asked for batch 8 (the
   manifest's 16 must win): 16 of 11b's requests from 16 clients, every
   answer 200 and each box within 1e-3 of the image's side of 11b's
   answer; /healthz, /stats as sent; K1 30 a batch. d) The op's host
   cost: 50 back-to-back K1 calls through the op, through its
   implementation (attention._fwd_op_cuda) and through the same
   implementation as a torch.library.custom_op, at BERT-base 40^2 (B=16) and
   the encoder's 440^2 (B=8), bf16, in turns; the bf16 batch-8 serving
   forward's host ms with flash_attention through the op and through the
   implementation, in turns; K1 at phase 11's sites of the server's batch
   (BERT-base 40^2, the decoder's 1x1 and 1x440, B=16, bf16) and SDPA on
   the same inputs: device ms by CUDA events with the calls queued behind
   a sleep kernel (the host kept out), beside the bound. e) tools/op_profile.profile("rec") (its
   table must name K1's tc and dec kernels), tools/conv_profile.profile()
   (B=32, 640 px) and phase 6's entry point with --profile_dir over 12
   steps (steps 10-11 traced): a trace written that names a K1 kernel, 30
   launches of each kernel a step and of K1 an eval batch. 12e's
   op_profile runs the folded model, as the JAX tool does.
13. The backbone's folds and the JAX step's knobs, on phase 11's .pth
   and in its temporary directory. a) tools/serve.build_server with
   --fold_bn --fold_normalize (the .pth by URL, folded as it loads; serve
   batch 16), 16 of 11b's requests in bf16 and 8 in float32 from 8
   clients: every answer 200 and within 1e-3 (bf16) or 1e-4 (float32) of
   the image's side of the server's own model run directly on the same
   rows; K1 30 a batch, K2 and K3 none; the same rows through the
   unfolded model and the fold_bn-only model: the fold_bn-only boxes
   within those limits of the unfolded one's, the --fold_normalize
   model's within 1e-3 in bf16; in float32 its boxes' distance is
   reported (its padding taps beyond the canvas mean black pixels, the
   unfolded model's zero in normalised space: nn/fold.py) and layer1's
   output inside its edge ring is held within 2e-4 of its largest
   magnitude, where the fold is exact. b) The folded bf16 model
   exported and loaded as in 12a-b (the manifest's fold_bn and
   fold_normalize true). c) op_profile rec (bf16, batch 64) unfolded and
   folded, in turns, report only: device ms, the elementwise kernels' ms
   and share. d) REC's bf16 batch-8 step with --space_to_depth_stem
   --fold_bn against the standard backbone, in turns: device ms, host ms,
   peak memory; 30 launches of each kernel a counted step. e) The
   four-level bf16 step (8540 tokens), batch 8, with --remat
   --backbone_remat against without, on one model: one forward and
   backward each way at dropout 0.1 from the same seeds, loss within
   1e-5 relative and every gradient within 1e-3 rel L2 (phase 5's rule);
   then in turns peak memory and device ms, and the launches of a counted
   step: 30 of each kernel, and with remat 6 more of K1 (each recomputed
   encoder layer's).
14. Print one JSON line listing each kernel (each variant on a row of its
   own; the decode backward on one row for K2 and K3) with its launches
   on the main paths (phase 8's, 10's, 11's, 12's and 13's runs included,
   also on their own), its error (phase 10's and 11's checks at their own sites
   also on their own), and its times and bound at the call site where
   the main path launches it (the decoder's cross-attention for the
   decode and SIMT kernels, the VL encoder for the tensor-core kernels, in
   float32 for the 3xTF32 ones, the four-level encoder at B=8 for the
   warpgroup kernels, from phase 3d) on this card.
15. Print {"ok": true, "device": {...}} as the last line.

It needs a CUDA card and the reftr_torch package beside it; without
either it fails before it prints any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

SERVE_BATCH = 8
N_REQUESTS = 6
ATTN_PER_FORWARD = 30  # 12 BERT-base + 6 encoder + 6 + 6 decoder layers
# (Sq, Sk, H, D) of each attention call site of refcoco_det at 640 px
CALL_SITES = {
    "vl_encoder_self": (440, 440, 8, 32),
    "decoder_self": (1, 1, 8, 32),
    "decoder_cross": (1, 440, 8, 32),
    "bert_self": (40, 40, 12, 64),
}
KERNEL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LSE_TOL = (1e-5, 1e-6)  # abs, rel: both variants sum in f32
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
MODEL_TOL_F32_ABS = 1e-4
MODEL_TOL_BF16_REL = 5e-2
DROPOUT = 0.1  # the preset's rate: attention and hidden dropout
TRAIN_STEPS = 20
WARM_STEPS = 3
# phase 5's step by the rule and with K3 on "tc": turns of each, steps a
# turn
K3_AB_TURNS = 4
K3_AB_STEPS = 5
TRAIN_LOSS_TOL = 1e-5  # f32 kernel path vs plain path, relative
TRAIN_GRAD_TOL = 1e-3  # relative L2 per trainable gradient
# kernels of the main paths: the C entry point, its source, the Pallas
# function it replaces, its variant
KERNELS = {
    "flash_attn_fwd": ("flash_attn_fwd.cu",
                       "reftr_tpu/kernels/attention.py:86", "simt"),
    "flash_attn_fwd_tc": ("flash_attn_fwd_tc.cu",
                          "reftr_tpu/kernels/attention.py:86", "tc"),
    "flash_attn_fwd_wg": ("flash_attn_fwd_wg.cu",
                          "reftr_tpu/kernels/attention.py:86", "wg"),
    "flash_attn_fwd_f32tc": ("flash_attn_fwd_f32tc.cu",
                             "reftr_tpu/kernels/attention.py:86", "tf32x3"),
    "flash_attn_fwd_dec": ("flash_attn_fwd_dec.cu",
                           "reftr_tpu/kernels/attention.py:86", "dec"),
    "flash_attn_bwd_dq": ("flash_attn_bwd.cu",
                          "reftr_tpu/kernels/attention.py:242", "simt"),
    "flash_attn_bwd_dq_tc": ("flash_attn_bwd_dq_tc.cu",
                             "reftr_tpu/kernels/attention.py:242", "tc"),
    "flash_attn_bwd_dq_wg": ("flash_attn_bwd_dq_wg.cu",
                             "reftr_tpu/kernels/attention.py:242", "wg"),
    "flash_attn_bwd_dq_f32tc": ("flash_attn_bwd_dq_f32tc.cu",
                                "reftr_tpu/kernels/attention.py:242",
                                "tf32x3"),
    "flash_attn_bwd_dkv": ("flash_attn_bwd.cu",
                           "reftr_tpu/kernels/attention.py:287", "simt"),
    "flash_attn_bwd_dkv_tc": ("flash_attn_bwd_dkv_tc.cu",
                              "reftr_tpu/kernels/attention.py:287", "tc"),
    "flash_attn_bwd_dkv_wg": ("flash_attn_bwd_dkv_wg.cu",
                              "reftr_tpu/kernels/attention.py:287", "wg"),
    "flash_attn_bwd_dkv_f32tc": ("flash_attn_bwd_dkv_f32tc.cu",
                                 "reftr_tpu/kernels/attention.py:287",
                                 "tf32x3"),
    # K2 and K3 in one kernel: replaces :242 and :287 (BWD_DEC_ALSO)
    "flash_attn_bwd_dec": ("flash_attn_bwd_dec.cu",
                           "reftr_tpu/kernels/attention.py:242", "dec"),
}
BWD_DEC_ALSO = "reftr_tpu/kernels/attention.py:287"
# products of each kernel over (query, valid key) pairs: K1 q k^T and p v;
# K2 q k^T, dO v^T and ds k; K3 those of K2 with (p keep)^T dO, ds^T q;
# the decode backward (flash_attn_bwd) K2's and K3's without repeats
PRODUCTS = {"flash_attn_fwd": 2, "flash_attn_bwd_dq": 3,
            "flash_attn_bwd_dkv": 4, "flash_attn_bwd": 5}
# attention calls per refcoco_det forward (and per step, for each of K1, K2
# and K3) that the dispatch rule sends to the tensor-core kernels: 12 BERT
# + 6 encoder (in float32 to the 3xTF32 ones); the decoder's 12
# single-query calls take K1's decode kernel and the decode backward
TC_PER_FORWARD = 18
# (calls per forward, Sq, Sk, D) of refcoco_det's attention sites at 640 px:
# BERT-base over 40 tokens, the VL encoder over 440, the decoder's self-
# and cross-attention of its single query
REC_SITES = ((12, 40, 40, 64), (6, 440, 440, 32), (6, 1, 1, 32),
             (6, 1, 440, 32))
F32_TRAIN_STEPS = 8  # the timed float32 training run
# the call site and dtype where the main path launches each variant, for
# the kernels line: the SIMT kernels have no launch on the main paths and
# stand at the decoder's site, where they ran before the decode kernels;
# the 3xTF32 kernels run in the float32 forward and step
MAIN_SITE = {"tc": "vl_encoder_self", "dec": "decoder_cross",
             "simt": "decoder_cross", "tf32x3": "vl_encoder_self",
             "wg": "vl_encoder_4_levels_b8"}
MAIN_DTYPE = {"tf32x3": "float32"}
# (B, Sq, Sk, H, D) where the rule sends K3 to SIMT: 16 or more queries and
# fewer than 16 keys, which no call site of the model reaches
SIMT_DKV_SITE = (SERVE_BATCH, 440, 8, 8, 32)
# head dims off the instances: (B, Sq, Sk, H, D), one that pads, ones
# that pad in the decode kernels, the largest instance and two above it,
# which the rule sends to the plain versions
HEAD_DIM_SWEEP = [(2, 70, 130, 4, 48), (2, 70, 130, 2, 96),
                  (2, 3, 130, 4, 24), (2, 65, 17, 3, 8),
                  (2, 70, 130, 2, 128), (2, 70, 130, 1, 160),
                  (2, 70, 130, 1, 256)]
# phase 6: the trainer's entry point, refcoco_det at full width in float32
# on the synthetic fixture; 64 train items and the fixed 64-item val split
# in batches of 8 make 8 train steps and 8 eval batches an epoch
CLI_OUT = ROOT / "chiprun_out" / "cli"
CLI_MODEL_DATA = ["--preset", "refcoco_det", "--dataset", "synthetic",
                  "--test_split", "val", "--synthetic_n", "64",
                  "--batch_size", "8", "--num_workers", "4",
                  "--dtype", "float32"]
CLI_TRAIN = CLI_MODEL_DATA + ["--epochs", "2", "--run_epoch", "1",
                              "--auto_resume", "--output_dir", str(CLI_OUT)]
CLI_EVAL = CLI_MODEL_DATA + ["--eval", "--resume", str(CLI_OUT / "checkpoint")]
CLI_STEPS = 8
CLI_EVAL_BATCHES = 8
CLI_MIOU_TOL = 1e-5  # the eval-only pass against the log: sums in order
# phase 7: RES, refcoco_seg at full width (the mask head over C3, C2 and C1
# of the 640 px canvas): a bf16 fine-tune from phase 6's refcoco_det
# checkpoint through the entry point, 8 steps and 8 eval batches on the
# synthetic fixture with box-shaped masks, and its eval-only pass
RES_OUT = ROOT / "chiprun_out" / "res"
RES_MODEL_DATA = ["--preset", "refcoco_seg", "--dataset", "synthetic",
                  "--test_split", "val", "--synthetic_n", "64",
                  "--batch_size", "8", "--num_workers", "4"]
RES_TRAIN = RES_MODEL_DATA + ["--epochs", "1", "--pretrained_model",
                              str(CLI_OUT / "checkpoint"), "--output_dir",
                              str(RES_OUT)]
RES_EVAL = RES_MODEL_DATA + ["--eval", "--resume", str(RES_OUT / "checkpoint")]
RES_FREEZE_STEPS = 4  # the float32 --freeze_reftr --ablation cem_loss run
RES_BOX_TOL = 1e-4  # f32 forward, kernel vs plain: pred_boxes max abs
RES_MASK_TOL = 1e-4  # and pred_masks relative L2
# the mask head's convolutions at 1/4 of the canvas (160 x 160 at 640 px),
# by weight shape: adapter3 (C1's 256 channels to 32), lay5 (32 to 16) and
# out_lay (16 to 1); layer1's convolutions there have 64 or 256 outputs
MASK_HEAD_160 = {(32, 256, 1, 1), (16, 32, 3, 3), (1, 16, 3, 3)}
MASK_HEAD_HW = (160, 160)
# phase 8: multi-phrase (preset flickr) at full width on the multi-phrase
# fixture (--dataset synthetic_multi) through the entry point in bf16 (the
# CLI's default): batch 16 of 90 sentence tokens and 16 phrase slots of 22
# tokens at 640 px; 128 train items make 8 steps, the fixture's 64 eval
# items 4 eval batches
MULTI_OUT = ROOT / "chiprun_out" / "multi"
MULTI_MODEL_DATA = ["--preset", "flickr", "--dataset", "synthetic_multi",
                    "--test_split", "val", "--synthetic_n", "128",
                    "--num_workers", "4"]
MULTI_TRAIN = MULTI_MODEL_DATA + ["--epochs", "1", "--output_dir",
                                  str(MULTI_OUT)]
MULTI_EVAL = MULTI_MODEL_DATA + ["--eval", "--resume",
                                 str(MULTI_OUT / "checkpoint")]
MULTI_STEPS = 8
MULTI_EVAL_BATCHES = 4
# (B, Sq, Sk, H, D) of the call sites phase 8 adds: flickr's BERT over the
# phrases, its decoder at 16 queries and its encoder over 90 + 20^2
# tokens; the VL encoder at four feature levels (40 + 80^2 + 40^2 + 20^2 +
# 10^2 tokens) at B=1, where the plain version's [B, H, S, S] scores fit
# (2.3 GB in float32), and at B=8 for the times alone
LONG_S = 8540
NEW_SITES = {
    "phrase_bert_self": (256, 22, 22, 12, 64),
    "multi_decoder_self": (16, 16, 16, 8, 32),
    "multi_decoder_cross": (16, 16, 490, 8, 32),
    "multi_vl_encoder_self": (16, 490, 490, 8, 32),
    "vl_encoder_4_levels": (1, LONG_S, LONG_S, 8, 32),
    "vl_encoder_4_levels_b8": (SERVE_BATCH, LONG_S, LONG_S, 8, 32),
    # the same with each image padded on the canvas, as a batch of images
    # of unequal sizes has it: masked keys in nearly every key tile
    "vl_encoder_4_levels_b8_padded": (SERVE_BATCH, LONG_S, LONG_S, 8, 32),
    # the VL encoders at 2 and 3 feature levels (phase 3d): refcoco_det's
    # 40 + 40^2 + 20^2 and 40 + 80^2 + 40^2 + 20^2 tokens, flickr's 90 +
    # 40^2 + 20^2
    "vl_encoder_2_levels_b8": (SERVE_BATCH, 2040, 2040, 8, 32),
    "vl_encoder_3_levels_b8": (SERVE_BATCH, 8440, 8440, 8, 32),
    "multi_vl_encoder_2_levels": (16, 2090, 2090, 8, 32),
    # the from-scratch recipe's (phase 10): BERT-tiny over refcoco_det's
    # 40 tokens (4 heads of 16) and the encoder over 440 at its batch of 16
    "scratch_bert_self": (16, 40, 40, 4, 16),
    "scratch_vl_encoder_self": (16, 440, 440, 8, 32),
    # phase 11's server at its batch of 16 (HTTP_BATCH): refcoco_det's
    # BERT-base over 40 tokens, the decoder's self-attention (1 query) and
    # cross-attention over 40 + 20^2 tokens; its encoder at that batch is
    # scratch_vl_encoder_self
    "serve_bert_self": (16, 40, 40, 12, 64),
    "serve_decoder_self": (16, 1, 1, 8, 32),
    "serve_decoder_cross": (16, 1, 440, 8, 32),
}
# the image tokens of the 640 px canvas at 1-4 feature levels: the last
# min(n, 3) backbone stages, 20^2, 40^2 and 80^2, and a 10^2 extra
IMAGE_TOKENS = (400, 2000, 8400, 8500)
# the four levels' feature maps of the 640 px canvas (strides 8-64)
LEVEL_SIDES = (80, 40, 20, 10)
MULTI_SITES = ("phrase_bert_self", "multi_decoder_self",
               "multi_decoder_cross", "multi_vl_encoder_self")
# (calls per forward, Sq, Sk, D) of flickr's and flickr_roberta's sites:
# BERT (or RoBERTa) over the 90-token sentence and the 22-token phrases,
# the encoder over 490, the decoder at 16 phrase queries
MULTI_FORWARD_SITES = ((12, 90, 90, 64), (12, 22, 22, 64),
                       (6, 490, 490, 32), (6, 16, 16, 32), (6, 16, 490, 32))
# refcoco_det at four feature levels through the entry point in bf16: 32
# train items in batches of 8 (4 steps), the fixture's 64 eval items (8
# eval batches)
LEVELS_OUT = ROOT / "chiprun_out" / "levels"
LEVELS_TRAIN = ["--preset", "refcoco_det", "--num_feature_levels", "4",
                "--dataset", "synthetic", "--test_split", "val",
                "--synthetic_n", "32", "--batch_size", "8", "--num_workers",
                "4", "--epochs", "1", "--output_dir", str(LEVELS_OUT)]
LEVELS_STEPS = 4
LEVELS_EVAL_BATCHES = 8
# (calls per forward, Sq, Sk, D) of refcoco_det at four feature levels
LEVELS_SITES = ((12, 40, 40, 64), (6, LONG_S, LONG_S, 32), (6, 1, 1, 32),
                (6, 1, LONG_S, 32))
# flickr_roberta on the multi-phrase fixture: RoBERTa-base's widths over a
# byte-level vocabulary written under --data_root (the 256 byte symbols
# and <s> <pad> </s> <unk>, no merges); 32 items in batches of 16
ROBERTA_OUT = ROOT / "chiprun_out" / "roberta"
ROBERTA_TRAIN = ["--preset", "flickr_roberta", "--dataset",
                 "synthetic_multi", "--data_root", str(ROBERTA_OUT / "data"),
                 "--test_split", "val", "--synthetic_n", "32",
                 "--num_workers", "4", "--epochs", "1", "--output_dir",
                 str(ROBERTA_OUT)]
ROBERTA_STEPS = 2
ROBERTA_EVAL_BATCHES = 4
# the element offset the kernels count in 64 bits: the masks are checked
# past it
OFFSET_32 = 2 ** 32
# phase 3d: the sites where the warpgroup kernels are timed against the
# mma.sync ones and SDPA, and the turns of each
WG_TIME_SITES = ("vl_encoder_self", "multi_vl_encoder_self",
                 "vl_encoder_2_levels_b8", "multi_vl_encoder_2_levels",
                 "vl_encoder_3_levels_b8", "vl_encoder_4_levels_b8",
                 "vl_encoder_4_levels_b8_padded", "multi_decoder_cross")
WG_TIME_TURNS = 3
# phase 3e: the shapes (B, Sq, Sk, H, D) at which the dropout draw of K1
# and K2 (flash_tc::keep_bits) is checked exact in every kernel that calls
# it: key counts that are not a multiple of 4, those of the model's sites
# (22, 90, 490, 2090: row offsets at phases 0 and 2 of a Philox counter)
# and odd ones (every phase), 16-130 queries (several 16-row warp tiles)
KEEP_SHAPES = ((2, 40, 22, 2, 32), (2, 40, 90, 2, 32), (2, 130, 490, 2, 32),
               (1, 70, 2090, 2, 32), (2, 70, 17, 2, 32), (2, 70, 131, 2, 32),
               (2, 130, 385, 3, 32))
# and past an element offset of 2^32 at a key count that is not a
# multiple of 4: the last batch row of B=8 at 8539^2 (no model site)
KEEP_SHAPE_PAST_2_32 = (8, 8539, 8539, 8, 32)
KEEP_VARIANTS = {"K1": ("tc", "wg", "tf32x3"), "K2": ("tc", "wg", "tf32x3")}
# phase 8f (report only): the key counts at which the float32 kernels and
# the plain float32 version are held to float64 (B=1, H=8, D=32):
# refcoco_det's encoder, one between, the encoder at four feature levels
GAP_KEYS = (440, 2000, LONG_S)
# NVIDIA H100 SXM data sheet: HBM rate, bf16 dense tensor-core rate, and
# float32-accurate products: 3xTF32 gets a third of the 495 TFLOP/s of TF32
# (the f32 FMA rate outside the tensor cores, 67 TFLOP/s, is lower)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
# per SM and clock: MUFU.EX2 results (the special-function units; 3.9
# TFLOP/s of special functions on the H100 SXM, FlashAttention-3's figure)
# and 32-bit integer multiply-adds (IMAD, half the FP32 rate)
EX2_PER_CLOCK = 16
IMAD_PER_CLOCK = 64
# the Philox4x32-10 multipliers (flash_common.cuh::philox4)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
# this card, for the bound: SMs, the SM clock nvidia-smi gives as its
# maximum, and the IMADs of one Philox call in the built K1-wg (phase 1)
CARD = {}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: the durations of the device
    activities (kernels, copies, sets) that torch.profiler records over
    ``iters`` calls, summed and divided by ``iters``. Unlike ``cuda_ms``,
    which times back-to-back calls with events and so includes the host's
    time between launches where it exceeds the kernel's, this is the time
    the card spent on the call's work. A window in which the profiler
    recorded no device activity at all (seen once in some hundred windows
    on the H100, and once three times in a row) is profiled again after
    a pause, up to 6 times in all; then the time is not measured (None),
    which is printed as such: it is a measurement, not a check."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(6):
        if attempt:
            time.sleep(0.5)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(ev.device_time_total for ev in prof.events()
                       if ev.device_type == DeviceType.CUDA
                       and ev.device_time_total > 0
                       and not getattr(ev, "is_user_annotation", False))
        if total_us > 0:
            return total_us / 1e3 / iters
    print("profile: torch.profiler recorded no device time in 6 windows: "
          "not measured", flush=True)
    return None


def fmt_ms(ms) -> str:
    """A time to 4 places, or "not measured" where the profiler gave
    none."""
    return "not measured" if ms is None else f"{ms:.4f}"


def sum_ms(*values):
    """The sum of times, None if any is not measured."""
    return None if None in values else sum(values)


def sass_text(so: Path) -> str:
    """A built library's machine code (cuobjdump -sass, beside nvcc in the
    toolkit)."""
    from reftr_torch.kernels import _nvcc

    tool = Path(_nvcc.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_count(so: Path, opcode: str, text: str = None) -> int:
    """Instructions of ``opcode`` in a built library's machine code."""
    pattern = re.compile(rf"\*/\s+(@!?P\w+\s+)?{opcode}\b")
    return sum(bool(pattern.search(line)) for line in (
        text if text is not None else sass_text(so)).splitlines())


# the opcodes counted in the bf16 kernels' machine code (phase 1)
SASS_OPCODES = ("HMMA", "HGMMA", "MUFU.EX2", "FFMA", "FMUL", "FADD",
                "FMNMX", "F2FP", "IMAD", "LOP3", "SHFL", "LDS", "LDG")


def function_sass(text: str, marker: str) -> str:
    """The machine code of the one function whose name holds ``marker``
    (cuobjdump -sass prints a "Function : <mangled name>" line before
    each)."""
    parts = re.split(r"\n\s*Function : ", text)
    found = [p for p in parts[1:] if marker in p.split("\n", 1)[0]]
    return found[0] if len(found) == 1 else ""


# the sources whose kernels draw dropout by flash_tc::keep_bits: each is
# instantiated for Sk % 4 == 0's path and the general one
KEEP_CALLERS = ("flash_attn_fwd_tc.cu", "flash_attn_fwd_wg.cu",
                "flash_attn_fwd_f32tc.cu", "flash_attn_bwd_dq_tc.cu",
                "flash_attn_bwd_dq_wg.cu", "flash_attn_bwd_dq_f32tc.cu")


def instance_markers(src: str, variant: str) -> dict:
    """The part of the D=32 instance's mangled name that picks it in the
    machine code and in ptxas's log: a "tc" or "tf32x3" kernel's holds
    ILi32E, a "wg" kernel has that one instance, named *_wg_kernel; a
    keep_bits caller's two instances add Lb1E (Sk % 4 == 0) or Lb0E."""
    base = "wg_kernel" if variant == "wg" else "ILi32E"
    if src not in KEEP_CALLERS:
        return {"": base}
    sep = "I" if variant == "wg" else ""
    return {"Sk % 4 == 0": f"{base}{sep}Lb1E",
            "Sk % 4 != 0": f"{base}{sep}Lb0E"}


def ptxas_lines(log: list, marker: str) -> list:
    """ptxas's lines (registers, spills, C7514) of the function whose
    "Compiling entry" line holds ``marker``."""
    at = next((i for i, line in enumerate(log)
               if "Compiling entry" in line and marker in line), None)
    return ([] if at is None else
            [line.split(":", 1)[-1].strip() for line in log[at + 1:at + 4]
             if "spill" in line or "registers" in line or "C7514" in line])


def sass_profile(libs: dict) -> dict:
    """Per tensor-core kernel at D = 32 (each instance of a keep_bits
    caller: instance_markers), the static count of each of SASS_OPCODES in
    its machine code (the whole function: its unrolled loop, prologue and
    epilogue, the dropout path and the path without), and ptxas's lines
    for it (registers, spills; -Xptxas -v, kept beside the library)."""
    out = {}
    for src, _, variant in KERNELS.values():
        if variant not in ("tc", "wg", "tf32x3") or src in out:
            continue
        text = sass_text(libs[src])
        log = libs[src].with_suffix(".log").read_text().split("\n")
        for path, marker in instance_markers(src, variant).items():
            code = function_sass(text, marker)
            # None where the machine code does not hold one such function
            out[f"{src} {path}".strip()] = {
                "ptxas": ptxas_lines(log, marker),
                "sass": {op: sass_count(None, op, code)
                         for op in SASS_OPCODES} if code else None}
    return out


def philox_imad_per_call(text: str):
    """The integer multiply-adds one Philox4x32-10 call issues, counted in
    machine code: the IMAD instructions that take a Philox multiplier (as
    an immediate, or its negative), over the calls. Every round multiplies
    counter word 0 by the first multiplier, so a call has 10 such products,
    one instruction each where the compiler forms the 64-bit product in
    one IMAD.WIDE, two (.HI and the low word) otherwise. None where the
    code holds no such instruction."""
    forms = {m: (f"0x{m:x}", f"-0x{(1 << 32) - m:x}") for m in PHILOX_M}
    count = {m: 0 for m in PHILOX_M}
    wide = 0
    for line in text.splitlines():
        if "IMAD" not in line:
            continue
        for m, (pos, neg) in forms.items():
            if re.search(rf"(?<![\w-]){pos}\b|{neg}\b", line):
                count[m] += 1
                wide += m == PHILOX_M[0] and ".WIDE" in line
    first = count[PHILOX_M[0]]
    if first == 0:
        return None
    calls = first / (10 * (1 if wide == first else 2))
    return sum(count.values()) / calls


def card_numbers(libs: dict) -> dict:
    """CARD: the SM count, the SM clock nvidia-smi gives as its maximum
    (clocks.max.sm, MHz) and the IMADs of a Philox call in K1-wg's
    machine code."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    CARD.update({
        "sms": torch.cuda.get_device_properties(0).multi_processor_count,
        "sm_clock_hz": float(out.stdout.strip().splitlines()[0]) * 1e6,
        "philox_imad_per_call": philox_imad_per_call(
            sass_text(libs["flash_attn_fwd_wg.cu"]))})
    return CARD


def attention_bound_terms(b, sq, sk, h, d, valid, dtype_name,
                          kernel="flash_attn_fwd", dropout=0.0) -> dict:
    """The least time (ms) one call of ``kernel`` could take on this card,
    by what limits it: "bytes", each input read once and each output
    written once (the forward reads q, k, v and writes out; the backward
    kernels read q, k, v, O, dO and lse and write dq, or dk and dv, or, the
    decode backward, flash_attn_bwd, all three); "tensor", its products
    over the (query, key) pairs this data needs (the valid keys; all sk
    keys for a row with none valid) at the tensor cores' peak; "exp", one
    MUFU.EX2 a pair at EX2_PER_CLOCK a clock per SM; with dropout
    "philox", a quarter of a Philox call a pair (one call gives four
    decisions) at CARD's IMADs per call, IMAD_PER_CLOCK a clock per SM."""
    import torch

    # every variant of a kernel does the same work
    for suffix in ("_f32tc", "_tc", "_wg", "_dec"):
        kernel = kernel.removesuffix(suffix)
    es = 4 if dtype_name == "float32" else 2
    qs, ks = b * sq * h * d * es, b * sk * h * d * es
    lse = b * h * sq * 4
    nbytes = {"flash_attn_fwd": 2 * qs + 2 * ks,
              "flash_attn_bwd_dq": 4 * qs + 2 * ks + lse,
              "flash_attn_bwd_dkv": 3 * qs + 4 * ks + lse,
              "flash_attn_bwd": 4 * qs + 4 * ks + lse}[kernel] + b * sk
    keys = torch.where(valid.any(-1), valid.sum(-1), sk)
    pairs = h * sq * float(keys.sum())
    sm_rate = CARD["sms"] * CARD["sm_clock_hz"]
    terms = {"bytes": nbytes / PEAK_BYTES_S * 1e3,
             "tensor": (2.0 * PRODUCTS[kernel] * d * pairs
                        / PEAK_FLOPS[dtype_name] * 1e3),
             "exp": pairs / (EX2_PER_CLOCK * sm_rate) * 1e3}
    if dropout > 0.0 and CARD.get("philox_imad_per_call"):
        terms["philox"] = (pairs / 4 * CARD["philox_imad_per_call"]
                           / (IMAD_PER_CLOCK * sm_rate) * 1e3)
    return terms


def attention_bound_ms(b, sq, sk, h, d, valid, dtype_name,
                       kernel="flash_attn_fwd", dropout=0.0) -> tuple:
    """The largest of attention_bound_terms, and what it is: "bytes" or
    "operations" (tensor products, exponentials or Philox's multiplies)."""
    terms = attention_bound_terms(b, sq, sk, h, d, valid, dtype_name, kernel,
                                  dropout)
    top = max(terms, key=terms.get)
    return terms[top], "bytes" if top == "bytes" else "operations"


def kernel_tol(name: str, site: str, want) -> float:
    """K1's tolerance against the plain version in float32 on the same
    inputs at ``site``. In float32, KERNEL_TOL. In bf16, KERNEL_TOL of the
    largest output, and never more than KERNEL_TOL: the roundings of the
    output and of P to bf16 are each 2^-9 of what they round, so the error
    follows the output's size. Where every row has thousands of live keys
    (the encoder at 2-4 feature levels) the output is about
    sqrt(e / keys) = 0.02 and an absolute 2e-2 would pass a P V that is
    partly wrong. At phrase BERT it is one bf16 ulp of the largest output
    where that is more: rows of 2 keys with dropout reach 4.8 there, where
    the output's half ulp alone is 0.0156 and P's rounding adds to it."""
    if name == "float32":
        return KERNEL_TOL[name]
    top = want.float().abs().max().item()
    tol = KERNEL_TOL[name] * min(1.0, top)
    if site != "phrase_bert_self":
        return tol
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    return max(tol, ulp)


def site_shape(site) -> tuple:
    """(B, Sq, Sk, H, D) of a call site: refcoco_det's (CALL_SITES) at the
    serve batch, a site of phase 8 (NEW_SITES), or the shape itself where
    ``site`` is a tuple (phase 3e's)."""
    if isinstance(site, tuple):
        return site
    if site in CALL_SITES:
        return (SERVE_BATCH, *CALL_SITES[site])
    return NEW_SITES[site]


def new_site_valid(gen, b: int, sk: int):
    """The key masks phase 8's, 10's and 11's sites see: BERT over the
    40-token sentence, 10-20 real tokens; the decoder's one query over
    itself; BERT over phrases, "[CLS] [SEP]"
    (2 keys) in 14 of each image's 16 phrase rows and 3-9 keys in the
    other 2; the decoder's self-attention, the 2 real phrases' queries of
    16; over the encoder's memory, 10-20 real tokens of the sentence
    (flickr's 90 or refcoco_det's 40: the keys before the image tokens)
    and every image token (the fixture's square images fill the
    canvas)."""
    import torch

    ar = torch.arange(sk, device="cuda")[None]
    if sk == NEW_SITES["scratch_bert_self"][2]:
        # BERT over refcoco_det's sentence: the encoder's 10-20 real tokens
        lens = torch.randint(10, 21, (b,), device="cuda", generator=gen)
        return ar < lens[:, None]
    if sk == 1:
        return torch.ones(b, 1, dtype=torch.bool, device="cuda")
    if sk == NEW_SITES["phrase_bert_self"][2]:
        lens = torch.randint(3, 10, (b,), device="cuda", generator=gen)
        lens = torch.where(torch.arange(b, device="cuda") % 16 < 2, lens, 2)
        return ar < lens[:, None]
    if sk == NEW_SITES["multi_decoder_self"][2]:
        return (ar < 2).expand(b, sk).clone()
    n_lang = sk - max(n for n in IMAGE_TOKENS if n < sk)
    lens = torch.randint(10, 21, (b,), device="cuda", generator=gen)
    return (ar < lens[:, None]) | (ar >= n_lang)


def padded_levels_valid(gen, b: int):
    """The key masks of the four-level encoder over images of unequal
    sizes: 10-20 real tokens of the 40-token sentence, then each level's
    map (LEVEL_SIDES) valid over the image's part of the canvas, an image
    of 320-640 px on each side (the serving path's pad_batch)."""
    import torch

    n_lang = LONG_S - sum(side * side for side in LEVEL_SIDES)
    lens = torch.randint(10, 21, (b,), device="cuda", generator=gen)
    rows = [torch.arange(n_lang, device="cuda")[None] < lens[:, None]]
    hw = torch.randint(320, 641, (b, 2), device="cuda", generator=gen)
    for side in LEVEL_SIDES:
        cells = -(-hw * side // 640)  # the image's cells, rounded up
        ar = torch.arange(side, device="cuda")
        live = ((ar[None, :, None] < cells[:, 0, None, None])
                & (ar[None, None, :] < cells[:, 1, None, None]))
        rows.append(live.reshape(b, side * side))
    return torch.cat(rows, 1)


def site_inputs(gen, site, dtype):
    """q, k, v [B, S, H, D] in ``dtype`` and valid [B, Sk] at a call
    site's shape: for refcoco_det's sites and a shape given as a tuple
    random padding and batch row 0 fully masked, for phase 8's the masks
    of their path (``new_site_valid``)."""
    import torch

    b, sq, sk, h, d = site_shape(site)
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
               for s in (sq, sk, sk))
    if site == "vl_encoder_4_levels_b8_padded":
        return q, k, v, padded_levels_valid(gen, b)
    if not isinstance(site, tuple) and site not in CALL_SITES:
        return q, k, v, new_site_valid(gen, b, sk)
    lens = torch.randint(1, sk + 1, (b,), device="cuda", generator=gen)
    valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
    valid[0] = False  # a row whose keys are all masked
    return q, k, v, valid


def simt_timed(site: str, dtype_name: str) -> bool:
    """Whether phases 2 and 3 time the SIMT K1 and K2 beside the rule's
    variant at ``site`` in ``dtype_name``: only where the kernels line
    reads them (MAIN_SITE["simt"], bf16). The rule sends no call to
    them; elsewhere they are checked against the plain version and not
    timed."""
    return (site, dtype_name) == (MAIN_SITE["simt"], "bfloat16")


def check_kernel(report: dict) -> dict:
    """Phase 2: the flash kernel against its plain version per call site."""
    import torch
    import torch.nn.functional as F

    from reftr_torch.kernels.attention import (_launch_fwd, attention_plain,
                                               flash_attention, fwd_variant)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    worst = {"float32": 0.0, "bfloat16": 0.0}

    def check(what, got, want, name):
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        if not math.isfinite(err) or err > KERNEL_TOL[name]:
            raise AssertionError(f"{what} {name}: kernel vs plain max abs "
                                 f"error {err:.3g} > {KERNEL_TOL[name]}")
        worst[name] = max(worst[name], err)
        return err

    for site, (sq, sk, h, d) in CALL_SITES.items():
        b = SERVE_BATCH
        q32, k32, v32, valid = site_inputs(gen, site, torch.float32)
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :]
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v = q32.to(dt), k32.to(dt), v32.to(dt)
            want = attention_plain(q.float(), k.float(), v.float(), valid)
            variant = fwd_variant(sq, sk, dt, d)
            err = check(site, flash_attention(q, k, v, valid), want, name)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bias_dt = bias.to(dt)

            def kern():
                return flash_attention(q, k, v, valid)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=bias_dt)

            ms, dev = cuda_ms(kern), device_ms(kern)
            plain_ms = cuda_ms(lambda: attention_plain(q, k, v, valid))
            lib_ms, lib_dev = cuda_ms(sdpa), device_ms(sdpa)
            bound, bound_by = attention_bound_ms(b, sq, sk, h, d, valid, name)
            row = {"site": site, "dtype": name, "variant": variant, "B": b,
                   "Sq": sq, "Sk": sk, "H": h, "D": d, "max_abs_err": err,
                   "tol": KERNEL_TOL[name], "ms": ms, "device_ms": dev,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_device_ms": lib_dev, "bound_ms": bound,
                   "bound_by": bound_by}
            before = ""
            if variant != "simt":
                # the same-run "before": the SIMT kernel at this call site
                simt_err = check(f"{site} simt", _launch_fwd(
                    "simt", q, k, v, valid, 0.0, None, False)[0], want, name)

                def simt():
                    return _launch_fwd("simt", q, k, v, valid, 0.0, None,
                                       False)

                row["simt_max_abs_err"] = simt_err
                before = f"; simt err {simt_err:.3g}"
                if simt_timed(site, name):
                    row.update({"simt_ms": cuda_ms(simt),
                                "simt_device_ms": device_ms(simt)})
                    before += (f", {row['simt_ms']:.4f} ms host loop, "
                               f"{fmt_ms(row['simt_device_ms'])} ms device")
            rows.append(row)
            print(f"kernel {site:16s} {name:8s} {variant:4s} B={b} Sq={sq} "
                  f"Sk={sk} H={h} D={d}: max_abs_err {err:.3g} (tol "
                  f"{KERNEL_TOL[name]}) kernel {ms:.4f} ms host loop, "
                  f"{fmt_ms(dev)} ms device; plain {plain_ms:.4f} ms, sdpa "
                  f"{lib_ms:.4f} ms host loop, {fmt_ms(lib_dev)} ms device; "
                  f"bound {bound:.5f} ms ({bound_by}){before}", flush=True)
    report["call_sites"] = rows
    report["max_abs_err"] = worst
    return report


def sdpa_times(q, k, v, valid, do, rate: float) -> dict:
    """The yardsticks on the same inputs and mask:
    F.scaled_dot_product_attention's forward (device ms), and its backward,
    which covers K2 and K3 together: host loop ms as forward and backward
    minus forward, and device ms of the backward alone."""
    import torch
    import torch.nn.functional as F

    bias = torch.where(valid, 0.0, -1e9)[:, None, None, :].to(q.dtype)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias,
                                              dropout_p=rate)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qt, kt, vt), dot)

    out = fwd()
    return {"sdpa_bwd_ms": cuda_ms(fwd_bwd) - cuda_ms(fwd),
            "sdpa_fwd_device_ms": device_ms(fwd),
            "sdpa_bwd_device_ms": device_ms(lambda: torch.autograd.grad(
                out, (qt, kt, vt), dot, retain_graph=True))}


def check_mask_exact(gen, site, rate: float, seed: int, dtype,
                     first_row: int = 0, variant: str = None) -> int:
    """K1 with v one-hot over the head dim: out = p * keep / l for D keys
    at a time, so the kept set is read off exactly and must equal the
    plain Philox mask on every key with p > 0 (valid keys, or all keys of
    a fully masked row). The call goes to the variant the rule picks for
    the site and dtype, and in bf16 p of a live key stays far above bf16's
    smallest normal. With ``first_row`` the batch rows from it on are
    compared, against the plain mask drawn from their own offsets. With
    ``variant`` that kernel is launched directly instead.
    Returns the number of elements compared."""
    import torch

    from reftr_torch.kernels.attention import (_launch_fwd, flash_attention,
                                               philox_keep_plain)

    q, k, _, valid = site_inputs(gen, site, dtype)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda", first_row)
    live_keys = torch.where(valid.any(-1, keepdim=True), valid,
                            True)[first_row:]
    compared = 0
    for k0 in range(0, sk, d):
        n = min(d, sk - k0)
        v = torch.zeros(b, sk, h, d, device="cuda", dtype=dtype)
        v[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        out = (flash_attention(q, k, v, valid, dropout_rate=rate, seed=seed)
               if variant is None else
               _launch_fwd(variant, q, k, v, valid, rate, seed, False)[0])
        # [B - first_row, H, Sq, n]
        kept = out[first_row:, ..., :n].permute(0, 2, 1, 3) != 0
        live = live_keys[:, None, None, k0:k0 + n].expand_as(kept)
        if not torch.equal(kept[live], keep[..., k0:k0 + n][live]):
            raise AssertionError(f"{site}: K1's dropout mask "
                                 f"({variant or 'the rule'}) differs from "
                                 f"the plain Philox mask at keys {k0}+")
        compared += int(live.sum())
    return compared


def check_dq_mask_exact(site, rate: float, seed: int, dtype,
                        first_row: int = 0, variant: str = None) -> int:
    """K2 on inputs whose dq reveals each keep decision: q = 0 and lse = 0
    give p = 1 on every live key (0 on a masked one), dO and v one-hot on
    head dim 0 give dP = 1, and O = 0 gives di = 0, so ds is the keep
    multiplier itself; with k one-hot over the head dim for D keys at a
    time, dq = scale * ds for those keys. The kept set must equal the plain
    Philox mask on every live key (of the batch rows from ``first_row``
    on). The call goes to the variant the rule picks (K2 "tc" or "wg" in
    bf16 at the encoder and BERT sites, the decode backward at the
    decoder's), or to ``variant`` launched directly. Returns the number of
    elements compared."""
    import torch

    from reftr_torch.kernels.attention import (_launch_dq, flash_attn_bwd_dq,
                                               philox_keep_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    _, _, _, valid = site_inputs(gen, site, dtype)
    b, sq, sk, h, d = site_shape(site)
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda", first_row)
    live_keys = torch.where(valid.any(-1, keepdim=True), valid,
                            True)[first_row:]
    q = torch.zeros(b, sq, h, d, device="cuda", dtype=dtype)
    o = torch.zeros_like(q)
    do = torch.zeros_like(q)
    do[..., 0] = 1
    v = torch.zeros(b, sk, h, d, device="cuda", dtype=dtype)
    v[..., 0] = 1
    lse = torch.zeros(b, h, sq, device="cuda")
    compared = 0
    for k0 in range(0, sk, d):
        n = min(d, sk - k0)
        k = torch.zeros(b, sk, h, d, device="cuda", dtype=dtype)
        k[:, k0:k0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        args = (q, k, v, valid, o, lse, do, rate, seed)
        dq = (flash_attn_bwd_dq(*args) if variant is None
              else _launch_dq(variant, *args))
        kept = dq[first_row:, ..., :n].permute(0, 2, 1, 3) != 0
        live = live_keys[:, None, None, k0:k0 + n].expand_as(kept)
        if not torch.equal(kept[live], keep[..., k0:k0 + n][live]):
            raise AssertionError(f"{site}: K2's dropout mask "
                                 f"({variant or 'the rule'}) differs from "
                                 f"the plain Philox mask at keys {k0}+")
        compared += int(live.sum())
    return compared


def check_dv_mask_exact(site: str, rate: float, seed: int, dtype,
                        first_row: int = 0) -> int:
    """K3 on inputs whose dv reveals each keep decision: q = 0 makes p
    uniform over a row's valid keys (all keys of a fully masked row), so
    lse is the log of their count, and dO one-hot over the head dim for D
    queries at a time, from query i0, and zero for the others, gives
    dv_j[d] = p * keep(i0 + d, j). The kept set must equal the plain
    Philox mask on every live key (of the batch rows from ``first_row``
    on). The call goes to the variant the rule picks (K3-TC in bf16 at the
    encoder and BERT sites, the decode backward at the decoder's). Returns
    the number of elements compared."""
    import torch

    from reftr_torch.kernels.attention import (flash_attn_bwd_dkv,
                                               philox_keep_plain)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    _, k, v, valid = site_inputs(gen, site, dtype)
    b, sq, sk, h, d = site_shape(site)
    keep = philox_keep_plain(seed, b, h, sq, sk, rate, "cuda", first_row)
    live_keys = torch.where(valid.any(-1, keepdim=True), valid, True)
    q = torch.zeros(b, sq, h, d, device="cuda", dtype=dtype)
    o = torch.zeros_like(q)
    lse = live_keys.sum(-1).float().log()[:, None, None].expand(
        b, h, sq).contiguous()
    live_keys = live_keys[first_row:]
    compared = 0
    for i0 in range(0, sq, d):
        n = min(d, sq - i0)
        do = torch.zeros_like(q)
        do[:, i0:i0 + n, :, :n] = torch.eye(n, device="cuda")[:, None, :]
        _, dv = flash_attn_bwd_dkv(q, k, v, valid, o, lse, do, rate, seed)
        kept = dv[first_row:, ..., :n].permute(0, 2, 3, 1) != 0
        live = live_keys[:, None, None, :].expand_as(kept)
        if not torch.equal(kept[live], keep[:, :, i0:i0 + n][live]):
            raise AssertionError(f"{site}: K3's dropout mask differs from "
                                 f"the plain Philox mask at queries {i0}+")
        compared += int(live.sum())
    return compared


def same_bits(a, b) -> bool:
    """Bitwise equality of two float32 or bfloat16 tensors."""
    import torch

    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return torch.equal(a.view(view), b.view(view))


def max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def check_training_kernels(report: dict, sites=tuple(CALL_SITES),
                           key: str = "train_kernels",
                           simt_before: bool = True,
                           timed_dtypes=("float32", "bfloat16")) -> dict:
    """Phase 3: K1 with dropout, K2 and K3 against their plain versions at
    ``sites``, with the SIMT kernels beside the others (``simt_before``)
    and, where the rule sends K1, K2 or K3 to a warpgroup kernel, the
    mma.sync kernel beside it, and the exact dropout masks; the rows go to
    report[key] (phases 8 and 10 check their own sites so). Each call is
    timed in ``timed_dtypes``. K3-wg alone computes di
    = rowsum(dO * O) in its wrapper, which K2 gives it in a step; its
    timed calls take di computed before them."""
    import torch

    from reftr_torch.kernels.attention import (_launch_bwd_dec, _launch_dkv,
                                               _launch_dq, _launch_fwd,
                                               attention_bwd_plain,
                                               attention_plain, di_plain,
                                               dkv_variant, dq_variant,
                                               flash_attention,
                                               flash_attn_bwd_dkv,
                                               flash_attn_bwd_dq, fwd_variant)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for site in sites:
        b, sq, sk, h, d = site_shape(site)
        q32, k32, v32, valid = site_inputs(gen, site, torch.float32)
        do32 = torch.randn(b, sq, h, d, device="cuda", generator=gen)
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v, do = (x.to(dt) for x in (q32, k32, v32, do32))
            for rate in (0.0, DROPOUT):
                seed = 0x5EED_0000 + len(rows) if rate else None
                drop = dict(dropout_rate=rate, seed=seed)
                out, lse = flash_attention(q, k, v, valid, True, **drop)
                # the forward's reference in float32, as phase 2's: two
                # roundings to bf16 of one value may part by an ulp
                want, want_lse = attention_plain(q.float(), k.float(),
                                                 v.float(), valid, True,
                                                 **drop)
                fwd_tol = kernel_tol(name, site, want)
                bwd = (q, k, v, valid, out, lse, do, rate, seed)
                wants = attention_bwd_plain(*bwd)
                dq = flash_attn_bwd_dq(*bwd)
                dk, dv = flash_attn_bwd_dkv(*bwd)
                dec = dq_variant(sq, sk, dt, d) == "dec"
                # no variant sums with atomics: a second call on the same
                # inputs gives the same bits
                again = (*flash_attention(q, k, v, valid, True, **drop),
                         *(_launch_bwd_dec(*bwd) if dec else
                           (flash_attn_bwd_dq(*bwd),
                            *flash_attn_bwd_dkv(*bwd))))
                if not all(same_bits(x, y) for x, y in
                           zip((out, lse, dq, dk, dv), again)):
                    raise AssertionError(f"phase 3 {site} {name} dropout "
                                         f"{rate}: two calls of the "
                                         f"kernels differ")
                torch.cuda.synchronize()
                fwd_err = max_err(out, want)
                lse_err = max_err(lse, want_lse)
                lse_tol = LSE_TOL[0] + LSE_TOL[1] * want_lse.abs().max().item()
                scale = max(w.float().abs().max().item() for w in wants)
                errs = [max_err(g, w) for g, w in zip((dq, dk, dv), wants)]
                bad = (not math.isfinite(fwd_err)
                       or fwd_err > fwd_tol
                       or not lse_err <= lse_tol
                       or not all(math.isfinite(e) and
                                  e <= GRAD_TOL[name] * scale for e in errs))
                row = {"site": site, "dtype": name, "dropout": rate,
                       "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
                       "fwd_max_abs_err": fwd_err,
                       "fwd_tol": fwd_tol,
                       "lse_max_abs_err": lse_err, "lse_tol": lse_tol,
                       "dq_max_abs_err": errs[0], "dk_max_abs_err": errs[1],
                       "dv_max_abs_err": errs[2], "grad_scale": scale,
                       "grad_tol": GRAD_TOL[name] * scale,
                       "fwd_variant": fwd_variant(sq, sk, dt, d),
                       "dq_variant": dq_variant(sq, sk, dt, d),
                       "dkv_variant": dkv_variant(sq, sk, dt, d),
                       "bitwise_repeatable": True}
                if bad:
                    raise AssertionError(f"phase 3 {row}")
                timed = {
                    "fwd": lambda: flash_attention(q, k, v, valid, **drop)}
                if dec:  # one launch gives K2's and K3's gradients
                    timed["bwd"] = lambda: _launch_bwd_dec(*bwd)
                else:
                    timed["dq"] = lambda: flash_attn_bwd_dq(*bwd)
                    # di outside the timed call, as K2 hands it to K3-wg
                    # in a step (the other variants ignore it)
                    di = di_plain(out, do)
                    timed["dkv"] = lambda: flash_attn_bwd_dkv(*bwd, di=di)
                # the same-run "before": the SIMT kernel of each kernel that
                # the rule sends elsewhere at this site, and the mma.sync
                # kernel of K1, K2 and K3 where the rule sends them to "wg"
                before = {}
                if simt_before and row["fwd_variant"] != "simt":
                    before["simt_fwd"] = lambda: _launch_fwd(
                        "simt", q, k, v, valid, rate, seed, False)
                if simt_before and row["dq_variant"] != "simt":
                    before["simt_dq"] = lambda: _launch_dq("simt", *bwd)
                if simt_before and row["dkv_variant"] != "simt":
                    before["simt_dkv"] = lambda: _launch_dkv("simt", *bwd)
                if row["fwd_variant"] == "wg":
                    before["tc_fwd"] = lambda: _launch_fwd(
                        "tc", q, k, v, valid, rate, seed, False)
                if row["dq_variant"] == "wg":
                    before["tc_dq"] = lambda: _launch_dq("tc", *bwd)
                if row["dkv_variant"] == "wg":
                    before["tc_dkv"] = lambda: _launch_dkv("tc", *bwd)
                timed_here = name in timed_dtypes
                for tag, fn in before.items():
                    what = tag.split("_")[1]
                    got = fn()
                    torch.cuda.synchronize()
                    if what == "fwd":
                        err, tol = max_err(got[0], want), fwd_tol
                    elif what == "dq":
                        err = max_err(got, wants[0])
                        tol = GRAD_TOL[name] * scale
                    else:
                        err = max(max_err(g, w) for g, w in zip(got, wants[1:]))
                        tol = GRAD_TOL[name] * scale
                    row[f"{tag}_max_abs_err"] = err
                    if not err <= tol:
                        raise AssertionError(f"phase 3 {tag} {row}")
                    if tag not in ("simt_fwd", "simt_dq") or simt_timed(
                            site, name):
                        timed[tag] = fn
                if not timed_here:
                    rows.append(row)
                    print(f"{key.replace('_', ' ')} {site:16s} {name:8s} "
                          f"dropout {rate}: fwd err {fwd_err:.3g} (tol "
                          f"{fwd_tol:.3g}), lse err {lse_err:.3g} (tol "
                          f"{lse_tol:.3g}), dq/dk/dv err {errs[0]:.3g}/"
                          f"{errs[1]:.3g}/{errs[2]:.3g} (tol "
                          f"{GRAD_TOL[name] * scale:.3g}); K1/K2/K3 "
                          f"{row['fwd_variant']}/{row['dq_variant']}/"
                          f"{row['dkv_variant']}"
                          + "".join(f"; {tag.replace('_', ' ')} err "
                                    f"{row[f'{tag}_max_abs_err']:.3g}"
                                    for tag in before)
                          + "; bitwise repeatable", flush=True)
                    continue
                for what, fn in timed.items():
                    row[f"{what}_ms"] = cuda_ms(fn)
                    row[f"{what}_device_ms"] = device_ms(fn)
                row.update({
                    "fwd_plain_ms": cuda_ms(lambda: attention_plain(
                        q, k, v, valid, **drop), iters=10),
                    "bwd_plain_ms": cuda_ms(lambda: attention_bwd_plain(
                        *bwd), iters=10)})
                row.update(sdpa_times(q, k, v, valid, do, rate))
                for kern in PRODUCTS:
                    row[f"{kern}_bound_ms"], row[f"{kern}_bound_by"] = \
                        attention_bound_ms(b, sq, sk, h, d, valid, name, kern,
                                           rate)
                rows.append(row)
                before_ms = "".join(
                    f"; {tag.replace('_', ' ')} "
                    f"{fmt_ms(row[f'{tag}_device_ms'])}" for tag in before
                    if tag in timed)
                bwd_times = (
                    f"K2+K3 dec {row['bwd_ms']:.4f}, "
                    f"{fmt_ms(row['bwd_device_ms'])}"
                    if dec else
                    f"K2 {row['dq_variant']} {row['dq_ms']:.4f}, "
                    f"{fmt_ms(row['dq_device_ms'])}; K3 "
                    f"{row['dkv_variant']} {row['dkv_ms']:.4f}, "
                    f"{fmt_ms(row['dkv_device_ms'])}")
                print(f"{key.replace('_', ' ')} {site:16s} {name:8s} dropout {rate}: "
                      f"fwd err {fwd_err:.3g} (tol {fwd_tol:.3g}), lse "
                      f"err {lse_err:.3g} (tol {lse_tol:.3g}), dq/dk/dv err "
                      f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (tol "
                      f"{GRAD_TOL[name] * scale:.3g}); K1 "
                      f"{row['fwd_variant']} {row['fwd_ms']:.4f} ms host "
                      f"loop, {fmt_ms(row['fwd_device_ms'])} device; "
                      f"{bwd_times}"
                      f"; plain fwd "
                      f"{row['fwd_plain_ms']:.4f}, bwd "
                      f"{row['bwd_plain_ms']:.4f} ms; sdpa fwd "
                      f"{fmt_ms(row['sdpa_fwd_device_ms'])}, bwd "
                      f"{fmt_ms(row['sdpa_bwd_device_ms'])} ms device; bounds "
                      f"{row['flash_attn_fwd_bound_ms']:.5f}/"
                      f"{row['flash_attn_bwd_dq_bound_ms']:.5f}/"
                      f"{row['flash_attn_bwd_dkv_bound_ms']:.5f}/"
                      f"{row['flash_attn_bwd_bound_ms']:.5f} ms"
                      f"{before_ms} ms device; bitwise repeatable",
                      flush=True)
    dtypes = (("float32", torch.float32), ("bfloat16", torch.bfloat16))
    masks = {f"K1 {site} {name}": check_mask_exact(gen, site, DROPOUT,
                                                   0xC0FFEE, dt)
             for site in sites for name, dt in dtypes}
    masks.update({f"K2 {site} {name}": check_dq_mask_exact(site, DROPOUT,
                                                           0xD0D0, dt)
                  for site in sites for name, dt in dtypes})
    masks.update({f"K3 {site} {name}": check_dv_mask_exact(site, DROPOUT,
                                                           0xDEC0, dt)
                  for site in sites for name, dt in dtypes})
    print(f"{key.replace('_', ' ')}: K1's, K2's and K3's dropout masks equal the "
          f"plain Philox mask exactly on {sum(masks.values())} elements at "
          f"p > 0 ({masks})", flush=True)
    report[key] = rows
    report["mask_elements_checked" if key == "train_kernels"
           else f"{key}_mask_elements_checked"] = masks
    return report


def check_head_dims(report: dict) -> dict:
    """Phase 3b: head dims off the kernels' instances (HEAD_DIM_SWEEP), in
    float32 and bfloat16, without dropout and with rate 0.1: K1 (out and
    lse), K2 and K3 through the rule against the plain versions on the
    same inputs, at phase 3's tolerances. A head dim up to 128 is
    zero-padded to the next instance and launches kernels; one above takes
    the plain versions by the rule, launches nothing and counts in each
    wrapper's launches_plain."""
    import torch

    from reftr_torch.kernels.attention import (MAX_HEAD_DIM,
                                               attention_bwd_plain,
                                               attention_plain, dkv_variant,
                                               dq_variant, flash_attention,
                                               flash_attn_bwd_dkv,
                                               flash_attn_bwd_dq, fwd_variant,
                                               padded_head_dim)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    counters = (flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv)
    rows = []
    for b, sq, sk, h, d in HEAD_DIM_SWEEP:
        q32, k32, v32 = (torch.randn(b, s, h, d, device="cuda", generator=gen)
                         for s in (sq, sk, sk))
        do32 = torch.randn(b, sq, h, d, device="cuda", generator=gen)
        lens = torch.randint(1, sk + 1, (b,), device="cuda", generator=gen)
        valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
        valid[0] = False  # a row whose keys are all masked
        plain = d > MAX_HEAD_DIM
        for name, dt in (("float32", torch.float32),
                         ("bfloat16", torch.bfloat16)):
            q, k, v, do = (x.to(dt) for x in (q32, k32, v32, do32))
            for rate in (0.0, DROPOUT):
                seed = 0xD1A0_0000 + len(rows) if rate else None
                drop = dict(dropout_rate=rate, seed=seed)
                before = [(c.launches, c.launches_plain) for c in counters]
                out, lse = flash_attention(q, k, v, valid, True, **drop)
                bwd = (q, k, v, valid, out, lse, do, rate, seed)
                grads = (flash_attn_bwd_dq(*bwd),
                         *flash_attn_bwd_dkv(*bwd))
                torch.cuda.synchronize()
                moved = [(c.launches - n, c.launches_plain - m)
                         for c, (n, m) in zip(counters, before)]
                want, want_lse = attention_plain(q, k, v, valid, True, **drop)
                wants = attention_bwd_plain(*bwd)
                fwd_err = max_err(out, want)
                lse_err = max_err(lse, want_lse)
                lse_tol = LSE_TOL[0] + LSE_TOL[1] * want_lse.abs().max().item()
                scale = max(w.float().abs().max().item() for w in wants)
                errs = [max_err(g, w) for g, w in zip(grads, wants)]
                row = {"B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
                       "padded_to": None if plain else padded_head_dim(d),
                       "dtype": name, "dropout": rate,
                       "fwd_variant": fwd_variant(sq, sk, dt, d),
                       "dq_variant": dq_variant(sq, sk, dt, d),
                       "dkv_variant": dkv_variant(sq, sk, dt, d),
                       "fwd_max_abs_err": fwd_err, "lse_max_abs_err": lse_err,
                       "dq_max_abs_err": errs[0], "dk_max_abs_err": errs[1],
                       "dv_max_abs_err": errs[2], "grad_scale": scale,
                       "launches_moved": [m[0] for m in moved],
                       "launches_plain_moved": [m[1] for m in moved]}
                # a plain call launches nothing and counts as plain; a
                # kernel call the reverse
                routed = all((n == 0) == plain and (m > 0) == plain
                             for n, m in moved)
                if (not routed or not fwd_err <= KERNEL_TOL[name]
                        or not lse_err <= lse_tol
                        or not all(e <= GRAD_TOL[name] * scale
                                   for e in errs)):
                    raise AssertionError(f"phase 3b {row}")
                rows.append(row)
                print(f"head dims B={b} Sq={sq} Sk={sk} H={h} D={d} -> "
                      f"{row['padded_to'] or 'plain'} {name} dropout {rate}: "
                      f"K1 {row['fwd_variant']} err {fwd_err:.3g}, lse "
                      f"{lse_err:.3g}; K2 {row['dq_variant']} / K3 "
                      f"{row['dkv_variant']} dq/dk/dv err "
                      f"{errs[0]:.3g}/{errs[1]:.3g}/{errs[2]:.3g} (tol "
                      f"{GRAD_TOL[name] * scale:.3g}); launches moved "
                      f"{row['launches_moved']}, plain "
                      f"{row['launches_plain_moved']}", flush=True)
    plain_counts = {c.__name__ + "_plain": c.launches_plain
                    for c in counters}
    print(f"head dims: {len(rows)} calls within tolerance; launches_plain "
          f"{plain_counts}", flush=True)
    report["head_dims"] = rows
    report["launches_plain_after_sweep"] = plain_counts
    return report


def check_simt_dkv(report: dict) -> dict:
    """Phase 3c: K3's SIMT route at SIMT_DKV_SITE (random key padding,
    batch row 0 fully masked), in float32 and bfloat16, without dropout
    and with rate 0.1: dk and dv through the rule against
    attention_bwd_plain at phase 3's tolerance, one launch each, none of
    another variant; its times, bound, the plain backward's time and
    SDPA's (its backward covers dq, dk and dv)."""
    import torch

    from reftr_torch.kernels.attention import (attention_bwd_plain,
                                               dkv_variant, flash_attention,
                                               flash_attn_bwd_dkv)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    b, sq, sk, h, d = SIMT_DKV_SITE
    q32, do32 = (torch.randn(b, sq, h, d, device="cuda", generator=gen)
                 for _ in range(2))
    k32, v32 = (torch.randn(b, sk, h, d, device="cuda", generator=gen)
                for _ in range(2))
    lens = torch.randint(1, sk + 1, (b,), device="cuda", generator=gen)
    valid = torch.arange(sk, device="cuda")[None] < lens[:, None]
    valid[0] = False
    rows = []
    for name, dt in (("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        if dkv_variant(sq, sk, dt, d) != "simt":
            raise AssertionError(f"the rule does not send K3 at {sq}x{sk} "
                                 f"{name} to SIMT")
        q, k, v, do = (x.to(dt) for x in (q32, k32, v32, do32))
        for rate in (0.0, DROPOUT):
            seed = 0x53DC_0000 + len(rows) if rate else None
            out, lse = flash_attention(q, k, v, valid, True,
                                       dropout_rate=rate, seed=seed)
            bwd = (q, k, v, valid, out, lse, do, rate, seed)
            wants = attention_bwd_plain(*bwd)
            before = read_counts([flash_attn_bwd_dkv])
            dk, dv = flash_attn_bwd_dkv(*bwd)
            moved = {key: n - before[key] for key, n in
                     read_counts([flash_attn_bwd_dkv]).items()}
            torch.cuda.synchronize()
            scale = max(w.float().abs().max().item() for w in wants)
            err = max(max_err(g, w) for g, w in zip((dk, dv), wants[1:]))
            others = [n for key, n in moved.items()
                      if key != "flash_attn_bwd_dkv"]
            if (not err <= GRAD_TOL[name] * scale
                    or moved["flash_attn_bwd_dkv"] != 1 or any(others)):
                raise AssertionError(f"phase 3c {name} dropout {rate}: err "
                                     f"{err:.3g}, launches moved {moved}")

            def kern():
                return flash_attn_bwd_dkv(*bwd)

            bound, bound_by = attention_bound_ms(
                b, sq, sk, h, d, valid, name, "flash_attn_bwd_dkv", rate)
            row = {"dtype": name, "dropout": rate, "B": b, "Sq": sq,
                   "Sk": sk, "H": h, "D": d, "max_abs_err": err,
                   "grad_scale": scale, "ms": cuda_ms(kern),
                   "device_ms": device_ms(kern),
                   "plain_ms": cuda_ms(lambda: attention_bwd_plain(*bwd),
                                       iters=10),
                   "bound_ms": bound, "bound_by": bound_by,
                   **sdpa_times(q, k, v, valid, do, rate)}
            rows.append(row)
            print(f"simt K3 B={b} Sq={sq} Sk={sk} H={h} D={d} {name} "
                  f"dropout {rate}: dk/dv err {err:.3g} (tol "
                  f"{GRAD_TOL[name] * scale:.3g}); {row['ms']:.4f} ms host "
                  f"loop, {fmt_ms(row['device_ms'])} device; plain bwd "
                  f"{row['plain_ms']:.4f} ms; sdpa bwd "
                  f"{fmt_ms(row['sdpa_bwd_device_ms'])} ms device; bound "
                  f"{bound:.5f} ms ({bound_by})", flush=True)
    report["simt_dkv"] = rows
    return report


def wg_times(report: dict) -> list:
    """Phase 3d: the warpgroup kernels against the mma.sync ones and SDPA
    in one process, in bf16 at WG_TIME_SITES (the VL encoder at 1-4
    feature levels, B=8, at four with the sentence padded and also with
    each image padded on the canvas; flickr's encoder at 1 and 2 levels,
    B=16; flickr's decoder over 490 keys), without dropout and with 0.1.
    K1: "tc", "wg" and SDPA's forward; the backward: K2 "tc" and "wg"
    (each writing di), K3 "tc" and "wg", and SDPA's backward, which covers
    K2 and K3 together. Each in WG_TIME_TURNS turns of CUDA events around
    back-to-back calls (cuda_ms); the median is reported. "wg" is checked
    against the plain version at phase 3's tolerances (K2-wg's dq at
    GRAD_TOL of the largest plain gradient, K3-wg's dk and dv at GRAD_TOL
    of the larger of dk's and dv's), K2-wg's di against di_plain (1e-5
    plus 1e-5 relative) and K2-wg's bits on a repeated call: on all the
    inputs where the plain version's scores fit (B * H * Sq * Sk * 4 bytes
    under 4 GB), else on batch row 0, whose dropout offsets are the same
    at B=1. K3-wg takes di from K2-wg."""
    import torch
    import torch.nn.functional as F

    from reftr_torch.kernels.attention import (_launch_dkv, _launch_dq,
                                               _launch_fwd,
                                               attention_bwd_plain,
                                               attention_plain, di_plain,
                                               dkv_variant, dq_variant,
                                               fwd_variant)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0x3D)
    rows = []
    for site in WG_TIME_SITES:
        b, sq, sk, h, d = site_shape(site)
        q, k, v, valid = site_inputs(gen, site, torch.bfloat16)
        do = torch.randn(q.shape, device="cuda",
                         generator=gen).to(torch.bfloat16)
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :].to(q.dtype)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)
        fits = b * h * sq * sk * 4 < 4e9
        iters = 10 if sq * sk > 1e7 else 50
        for rate in (0.0, DROPOUT):
            seed = 0x3D00 + len(rows) if rate else None
            out, lse = _launch_fwd("wg", q, k, v, valid, rate, seed, True)
            bwd = (q, k, v, valid, out, lse, do, rate, seed)
            di = torch.empty_like(lse)
            got = {"fwd": out, "dq": _launch_dq("wg", *bwd, di_out=di)}
            got["dk"], got["dv"] = _launch_dkv("wg", *bwd, di)
            di_want = di_plain(out, do)
            di_err = max_err(di, di_want)
            di_tol = 1e-5 + 1e-5 * di_want.abs().max().item()
            if not (di_err <= di_tol and same_bits(
                    got["dq"], _launch_dq("wg", *bwd))):
                raise AssertionError(f"phase 3d {site} dropout {rate}: "
                                     f"K2-wg's di error {di_err:.3g} (tol "
                                     f"{di_tol:.3g}) or a repeated call's "
                                     f"bits differ")
            against, ref = "plain", bwd
            if not fits:  # batch row 0 alone
                against = "plain, batch row 0"
                ref = tuple(x[:1] if torch.is_tensor(x) else x for x in bwd)
                got = {g: x[:1] for g, x in got.items()}
            want = {"fwd": attention_plain(*(x.float() for x in ref[:3]),
                                           ref[3], dropout_rate=rate,
                                           seed=seed)}
            want["dq"], want["dk"], want["dv"] = attention_bwd_plain(*ref)
            torch.cuda.synchronize()
            scale = max(want[g].float().abs().max().item()
                        for g in ("dk", "dv"))
            scale_dq = max(scale, want["dq"].float().abs().max().item())
            errs = {g: max_err(got[g], want[g]) for g in want}
            tols = {"fwd": kernel_tol("bfloat16", site, want["fwd"]),
                    "dq": GRAD_TOL["bfloat16"] * scale_dq,
                    "dk": GRAD_TOL["bfloat16"] * scale,
                    "dv": GRAD_TOL["bfloat16"] * scale}
            if not all(errs[g] <= tols[g] for g in errs):
                raise AssertionError(f"phase 3d {site} dropout {rate}: wg "
                                     f"against {against}: {errs}, tolerances "
                                     f"{tols}")

            def sdpa():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias, dropout_p=rate)

            held = sdpa()
            fns = {
                "k1_tc": lambda: _launch_fwd("tc", q, k, v, valid, rate, seed,
                                             False),
                "k1_wg": lambda: _launch_fwd("wg", q, k, v, valid, rate, seed,
                                             False),
                "sdpa_fwd": sdpa,
                "k2_tc": lambda: _launch_dq("tc", *bwd, di_out=di),
                "k2_wg": lambda: _launch_dq("wg", *bwd, di_out=di),
                "k3_tc": lambda: _launch_dkv("tc", *bwd),
                "k3_wg": lambda: _launch_dkv("wg", *bwd, di),
                "sdpa_bwd": lambda: torch.autograd.grad(
                    held, (qt, kt, vt), dot, retain_graph=True)}
            turns = {name: [] for name in fns}
            for _ in range(WG_TIME_TURNS):
                for name, fn in fns.items():
                    turns[name].append(cuda_ms(fn, iters=iters, warmup=2))
            ms = {name: statistics.median(t) for name, t in turns.items()}
            row = {"site": site, "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
                   "dropout": rate, "checked_against": against,
                   "max_abs_err": errs, "tol": tols, "grad_scale": scale,
                   "grad_scale_dq": scale_dq, "di_max_abs_err": di_err,
                   "di_tol": di_tol, "fwd_scale": want["fwd"].abs().max().item(),
                   "ms": ms,
                   "turns": turns,
                   "k2_wg_k3_wg_ms": ms["k2_wg"] + ms["k3_wg"],
                   "k2_tc_k3_wg_ms": ms["k2_tc"] + ms["k3_wg"],
                   "k2_tc_k3_tc_ms": ms["k2_tc"] + ms["k3_tc"],
                   "fwd_variant": fwd_variant(sq, sk, torch.bfloat16, d),
                   "dq_variant": dq_variant(sq, sk, torch.bfloat16, d),
                   "dkv_variant": dkv_variant(sq, sk, torch.bfloat16, d),
                   "bounds": {kern: attention_bound_terms(
                       b, sq, sk, h, d, valid, "bfloat16", kern, rate)
                       for kern in ("flash_attn_fwd", "flash_attn_bwd_dq",
                                    "flash_attn_bwd_dkv")}}
            rows.append(row)
            bounds = "; ".join(
                f"{kern.removeprefix('flash_attn_')} " + ", ".join(
                    f"{t} {v:.4f}" for t, v in terms.items())
                for kern, terms in row["bounds"].items())
            print(f"wg times {site} B={b} Sq={sq} Sk={sk} bf16 dropout {rate} "
                  f"({report['card']}; CUDA events, median of "
                  f"{WG_TIME_TURNS} turns): K1 tc {ms['k1_tc']:.4f}, wg "
                  f"{ms['k1_wg']:.4f}, sdpa fwd {ms['sdpa_fwd']:.4f} ms; K2 "
                  f"tc {ms['k2_tc']:.4f}, wg {ms['k2_wg']:.4f}; K3 tc "
                  f"{ms['k3_tc']:.4f}, wg {ms['k3_wg']:.4f}; K2 + K3 tc + tc "
                  f"{row['k2_tc_k3_tc_ms']:.4f}, tc + wg "
                  f"{row['k2_tc_k3_wg_ms']:.4f}, wg + wg "
                  f"{row['k2_wg_k3_wg_ms']:.4f}, sdpa bwd "
                  f"{ms['sdpa_bwd']:.4f} ms; the rule: K1 "
                  f"{row['fwd_variant']}, K2 {row['dq_variant']}, K3 "
                  f"{row['dkv_variant']}; wg against {against}: fwd "
                  f"{errs['fwd']:.3g} (largest output "
                  f"{row['fwd_scale']:.3g}, tol {tols['fwd']:.3g}), dq "
                  f"{errs['dq']:.3g} (tol {tols['dq']:.3g}), dk "
                  f"{errs['dk']:.3g}, dv {errs['dv']:.3g} (tol "
                  f"{tols['dk']:.3g}), di {di_err:.3g}; bounds (ms) "
                  f"{bounds}", flush=True)
            del out, lse, got, want, held, di_want
        del q, k, v, do, qt, kt, vt
        torch.cuda.empty_cache()
    report["wg_times"] = rows
    return rows


def check_keep_bits(report: dict) -> dict:
    """Phase 3e: the dropout draw of K1 and K2 (flash_tc::keep_bits) exact
    in every kernel that calls it (KEEP_VARIANTS), each launched directly,
    at KEEP_SHAPES in its dtype (bf16 for "tc" and "wg", float32 for
    "tf32x3"), and in bf16 in the last batch row of KEEP_SHAPE_PAST_2_32,
    whose element offsets run past 2^32 at a key count that is not a
    multiple of 4: the kept set read off K1's output (check_mask_exact)
    and off K2's dq (check_dq_mask_exact) equals the plain Philox mask on
    every live key."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0x3E)
    compared = {}

    def check(kernel, variant, shape, dtype, seed, first_row=0):
        if kernel == "K1":
            return check_mask_exact(gen, shape, DROPOUT, seed, dtype,
                                    first_row, variant)
        return check_dq_mask_exact(shape, DROPOUT, seed, dtype, first_row,
                                   variant)

    for shape in KEEP_SHAPES:
        for kernel, variants in KEEP_VARIANTS.items():
            for variant in variants:
                dt = torch.float32 if variant == "tf32x3" else torch.bfloat16
                compared[f"{kernel} {variant} {shape}"] = check(
                    kernel, variant, shape, dt, 0x3E00 + len(compared))
    b, sq, sk, h, _ = KEEP_SHAPE_PAST_2_32
    first = b - 1
    if not (first * h * sq * sk < OFFSET_32 < b * h * sq * sk and sk % 4):
        raise AssertionError(f"phase 3e: {KEEP_SHAPE_PAST_2_32} does not "
                             f"cross 2^32 in its last batch row at a key "
                             f"count off a multiple of 4")
    for kernel, variants in KEEP_VARIANTS.items():
        for variant in variants:
            if variant == "tf32x3":
                continue
            tag = f"{kernel} {variant} {KEEP_SHAPE_PAST_2_32} row {first}"
            compared[tag] = check(kernel, variant, KEEP_SHAPE_PAST_2_32,
                                  torch.bfloat16,
                                  0x2_0000_3E00 + len(compared), first)
            torch.cuda.empty_cache()
    if not all(compared.values()):
        raise AssertionError(f"phase 3e: no element compared: {compared}")
    print(f"keep bits: the dropout masks of K1 and K2 through "
          f"{KEEP_VARIANTS} equal the plain Philox mask exactly on "
          f"{sum(compared.values())} elements at p > 0, at Sk "
          f"{sorted({x[2] for x in KEEP_SHAPES})} and in batch row {first} "
          f"of {KEEP_SHAPE_PAST_2_32} (element offsets "
          f"{first * h * sq * sk} to {b * h * sq * sk - 1}, past "
          f"{OFFSET_32}): {compared}", flush=True)
    report["keep_bits_masks"] = compared
    return report


def make_requests(rng: np.random.Generator, img: int, seq: int, vocab: int):
    from reftr_torch.serve import Request

    reqs = []
    for i in range(N_REQUESTS):
        k = int(rng.integers(1, 4))
        vh, vw = (int(x) for x in rng.integers(img // 2, img + 1, size=2))
        if i == 0:
            vh = vw = img  # one canvas filled to the edge
        canvas = np.zeros((img, img, 3), np.uint8)
        canvas[:vh, :vw] = rng.integers(0, 256, (vh, vw, 3), dtype=np.uint8)
        valid = np.zeros((img, img), bool)
        valid[:vh, :vw] = True
        sent = np.zeros((k, seq), np.int32)
        sent_valid = np.zeros((k, seq), np.int32)
        for j in range(k):
            n = int(rng.integers(5, seq + 1))
            sent[j, :n] = rng.integers(1, vocab, n)
            sent_valid[j, :n] = 1
        rows = {"image": np.repeat(canvas[None], k, 0),
                "image_valid": np.repeat(valid[None], k, 0),
                "sentence": sent, "sentence_valid": sent_valid}
        # the canvas holds the image resized by 1/2: the served box is in
        # the original image's pixels
        reqs.append(Request(rows=rows, k=k, orig_hw=(2 * vh, 2 * vw),
                            valid_hw=(vh, vw)))
    return reqs


def forward_ms(model, batch, iters: int = 10) -> float:
    """Mean host time of one ServingModel call (device forward and fetch)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model(batch)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def ms_list(values) -> str:
    return ", ".join(f"{v:.2f}" for v in values)


VARIANT_COUNTS = ("launches_tc", "launches_wg", "launches_tf32x3",
                  "launches_dec", "launches_plain")


def reset_counts(counters) -> None:
    for c in counters:
        c.launches = 0
        for attr in VARIANT_COUNTS:
            if hasattr(c, attr):
                setattr(c, attr, 0)


def read_counts(counters) -> dict:
    """Launches per wrapper, and those of its tensor-core, warpgroup,
    3xTF32 and decode variants under ``<wrapper>_tc``, ``<wrapper>_wg``,
    ``<wrapper>_tf32x3`` and ``<wrapper>_dec``; its calls sent to the
    plain version under ``<wrapper>_plain``."""
    out = {}
    for c in counters:
        out[c.__name__] = c.launches
        for attr in VARIANT_COUNTS:
            if hasattr(c, attr):
                out[c.__name__ + attr.removeprefix("launches")] = getattr(
                    c, attr)
    return out


def serve_requests(model, reqs, counters, inside: bool = True) -> tuple:
    """Serve ``reqs`` through a MicroBatcher over ``model``, the launch
    counts set to 0 just before and read just after; every request must
    come back without error, with finite boxes inside its image (with
    ``inside`` False, finite only: a heatmap box's extent may pass its
    image's edge). Returns (launches, batches, seconds)."""
    from reftr_torch.serve import MicroBatcher

    reset_counts(counters)
    batcher = MicroBatcher(model, timeout_ms=5.0)
    t0 = time.perf_counter()
    for r in reqs:
        batcher.submit(r)
    for r in reqs:
        if not r.done.wait(timeout=300):
            raise AssertionError("a request was not answered in 300 s")
    served_s = time.perf_counter() - t0
    batcher.stop()
    launches = read_counts(counters)
    if batcher.thread.is_alive():
        raise AssertionError("the MicroBatcher thread did not stop")
    for i, r in enumerate(reqs):
        if r.error is not None:
            raise AssertionError(f"request {i} failed: {r.error}")
        if r.result is None or len(r.result) != r.k:
            raise AssertionError(f"request {i}: {r.k} phrases, result "
                                 f"{r.result}")
        h0, w0 = r.orig_hw
        for res in r.result:
            x0, y0, x1, y1 = res["box_xyxy"]
            if not all(math.isfinite(v) for v in (x0, y0, x1, y1)):
                raise AssertionError(f"request {i}: box {res['box_xyxy']}")
            if inside and not (0 <= x0 <= x1 <= w0 and 0 <= y0 <= y1 <= h0):
                raise AssertionError(f"request {i}: box {res['box_xyxy']} "
                                     f"outside its {w0}x{h0} image")
    n_batches = batcher.stats["batches"]
    if n_batches < 1:
        raise AssertionError("no batch was served")
    return launches, n_batches, served_s


def expected_launches(n: int, dtype_name: str, backward: bool,
                      sites=None) -> dict:
    """The counters (read_counts) after ``n`` forwards, or ``n`` train
    steps (``backward``), of a model whose forward makes the attention
    calls ``sites`` ((calls, Sq, Sk, D) each; refcoco_det's REC_SITES
    unless given) in ``dtype_name``: each call counted on the variant the
    dispatch rule picks for it (fwd_variant for K1, dq_variant and
    dkv_variant for K2 and K3 in a step; one decode backward counts on
    both)."""
    import torch

    from reftr_torch.kernels.attention import (dkv_variant, dq_variant,
                                               fwd_variant)

    dt = getattr(torch, dtype_name)
    names = ("flash_attention", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    want = {name + attr.removeprefix("launches"): 0 for name in names
            for attr in ("launches",) + VARIANT_COUNTS}
    for calls, sq, sk, d in REC_SITES if sites is None else sites:
        picks = {"flash_attention": fwd_variant(sq, sk, dt, d)}
        if backward:
            picks["flash_attn_bwd_dq"] = dq_variant(sq, sk, dt, d)
            picks["flash_attn_bwd_dkv"] = dkv_variant(sq, sk, dt, d)
        for name, variant in picks.items():
            if variant != "plain":
                want[name] += calls * n
            if variant != "simt":
                want[f"{name}_{variant}"] += calls * n
    return want


def serve(report: dict, counters) -> dict:
    """Phase 4: refcoco_det at full width behind the MicroBatcher."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.kernels.attention import flash_attention
    from reftr_torch.nn.attention import set_plain_attention
    from reftr_torch.serve import ServingModel, pad_batch
    from reftr_torch.tools.op_profile import profile_device

    cfg = {name: preset_config("refcoco_det", dtype=name)
           for name in ("float32", "bfloat16")}
    img = cfg["bfloat16"].data.img_size
    seq = cfg["bfloat16"].data.max_query_len
    vocab = cfg["bfloat16"].model.bert.vocab_size
    rng = np.random.default_rng(0)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = ServingModel(cfg["bfloat16"], SERVE_BATCH, device="cuda", seed=0)
    warm = make_requests(np.random.default_rng(1), img, seq, vocab)[:1]
    model(pad_batch(warm, SERVE_BATCH))  # first forward: cuDNN, kernel set-up
    torch.cuda.synchronize()
    print(f"serve: model built and warmed in {time.perf_counter() - t0:.1f} s",
          flush=True)

    reqs = make_requests(rng, img, seq, vocab)
    launches, n_batches, served_s = serve_requests(model, reqs, counters)
    rows = sum(r.k for r in reqs)
    want = expected_launches(n_batches, "bfloat16", False)
    if launches != want:
        raise AssertionError(
            f"launches {launches} for {n_batches} batch forwards, not "
            f"{want}")
    print(f"serve: {len(reqs)} requests, {rows} phrases in {n_batches} "
          f"batches of {SERVE_BATCH}, {served_s:.3f} s; launches {launches}",
          flush=True)

    # steady state: full padded batches through ServingModel, host to host,
    # with the kernel and with the plain attention in turns, after a warm-up
    # (the first timed forwards of a fresh process run slower)
    full = pad_batch(reqs[:1], SERVE_BATCH)
    forward_ms(model, full, iters=20)
    step_ms = {"kernel": [], "plain": []}
    for mode in ("kernel", "plain", "plain", "kernel") * 2:
        set_plain_attention(model.model, mode == "plain")
        step_ms[mode].append(forward_ms(model, full))
    set_plain_attention(model.model, False)
    step_s = statistics.median(step_ms["kernel"]) / 1e3
    plain_s = statistics.median(step_ms["plain"]) / 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"serve: bf16 batch {SERVE_BATCH} forward + fetch median "
          f"{step_s * 1e3:.2f} ms = {SERVE_BATCH / step_s:.1f} img/s (runs "
          f"{ms_list(step_ms['kernel'])} ms); with the plain attention "
          f"{plain_s * 1e3:.2f} ms = {SERVE_BATCH / plain_s:.1f} img/s (runs "
          f"{ms_list(step_ms['plain'])} ms); peak device memory "
          f"{peak_gb:.2f} GB", flush=True)

    report["profile"] = profile_device(
        lambda: model(full), f"bf16 batch {SERVE_BATCH} forward",
        step_s * 1e3)

    # the same requests served in float32: BERT and the encoder on the
    # 3xTF32 K1, the decoder on the decode kernel
    f32 = ServingModel(cfg["float32"], SERVE_BATCH, device="cuda", seed=0)
    f32(pad_batch(warm, SERVE_BATCH))
    launches32, n_batches32, served32_s = serve_requests(
        f32, make_requests(np.random.default_rng(0), img, seq, vocab),
        counters)
    want = expected_launches(n_batches32, "float32", False)
    if launches32 != want:
        raise AssertionError(
            f"float32: launches {launches32} for {n_batches32} batch "
            f"forwards, not {want}")
    print(f"serve: the same requests in float32 in {n_batches32} batches, "
          f"{served32_s:.3f} s; launches {launches32}", flush=True)
    f32_timing = time_f32_forward(f32, full, counters)

    # kernel path against the plain attention path on one batch
    compare = pad_batch(reqs[:3], SERVE_BATCH)
    outs = {}
    with torch.inference_mode():
        for name, m in (("float32", f32.model), ("bfloat16", model.model)):
            dev = {k: torch.from_numpy(v).cuda() for k, v in compare.items()}
            for plain in (False, True):
                set_plain_attention(m, plain)
                o = m(dev, return_internals=True)["internals"]
                outs[(name, plain)] = {k: o[k].float() for k in
                                       ("memory", "hs")}
            set_plain_attention(m, False)
    del f32
    errs = {}
    for key in ("memory", "hs"):
        want = outs[("float32", True)][key]
        if not torch.isfinite(want).all():
            raise AssertionError(f"plain float32 {key} is not finite")
        e32 = (outs[("float32", False)][key] - want).abs().max().item()
        rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
        e16 = rel(outs[("bfloat16", False)][key], want)
        e16p = rel(outs[("bfloat16", False)][key],
                   outs[("bfloat16", True)][key])
        errs[key] = {"f32_kernel_vs_plain_max_abs": e32,
                     "bf16_kernel_vs_f32_plain_rel_l2": e16,
                     "bf16_kernel_vs_bf16_plain_rel_l2": e16p}
        print(f"serve: {key} {tuple(want.shape)}: f32 kernel vs plain max abs"
              f" {e32:.3g} (tol {MODEL_TOL_F32_ABS}); bf16 kernel vs f32 plain"
              f" rel L2 {e16:.3g}, vs bf16 plain {e16p:.3g} (tol "
              f"{MODEL_TOL_BF16_REL})", flush=True)
        if not e32 <= MODEL_TOL_F32_ABS:
            raise AssertionError(f"{key}: f32 kernel vs plain {e32:.3g}")
        if not (e16 <= MODEL_TOL_BF16_REL and e16p <= MODEL_TOL_BF16_REL):
            raise AssertionError(f"{key}: bf16 rel L2 {e16:.3g}, {e16p:.3g}")
    report["serve"] = {"requests": len(reqs), "phrases": rows,
                       "batches": n_batches, "launches": launches,
                       "f32_batches": n_batches32,
                       "f32_launches": launches32,
                       "served_s": served_s, "bf16_forward_ms": step_s * 1e3,
                       "bf16_img_per_s": SERVE_BATCH / step_s,
                       "bf16_forward_runs_ms": step_ms,
                       "bf16_plain_attention_forward_ms": plain_s * 1e3,
                       "f32_forward": f32_timing,
                       "peak_memory_gb": peak_gb, "internals": errs}
    return report


def reroute(kernels, old: str, new: str) -> dict:
    """Send the dispatch rule's ``old`` calls of ``kernels`` (of "fwd",
    "dq", "dkv") to ``new`` (a same-run "before"). Returns the rule's
    functions, for restore_rule."""
    import reftr_torch.kernels.attention as attn

    def moved(rule):
        return lambda *a: new if rule(*a) == old else rule(*a)

    rule = {k: getattr(attn, f"{k}_variant") for k in kernels}
    for k, fn in rule.items():
        setattr(attn, f"{k}_variant", moved(fn))
    return rule



def restore_rule(rule: dict) -> None:
    import reftr_torch.kernels.attention as attn

    for k, fn in rule.items():
        setattr(attn, f"{k}_variant", fn)


def time_f32_forward(model, full, counters) -> dict:
    """Phase 4's float32 timing: full batches through ServingModel, host to
    host, after the bf16 timing's warm-up, in turns with K1 on the 3xTF32
    kernel and with K1 sent to SIMT (the same-run "before"), median of four
    turns each; one forward of each mode counted (18 of K1's 30 launches on
    the mode's kernel) and profiled."""
    from reftr_torch.tools.op_profile import profile_device

    forward_ms(model, full, iters=20)
    runs = {"tf32x3": [], "simt": []}
    launches = {}
    for mode in ("tf32x3", "simt", "simt", "tf32x3") * 2:
        rule = (reroute(["fwd"], "tf32x3", "simt") if mode == "simt"
                else {})
        runs[mode].append(forward_ms(model, full))
        if mode not in launches:
            reset_counts(counters)
            model(full)
            launches[mode] = read_counts(counters)
        restore_rule(rule)
    for mode in runs:
        n = launches[mode]
        on_mode = (n["flash_attention_tf32x3"] if mode == "tf32x3" else
                   n["flash_attention"] - n["flash_attention_dec"]
                   - n["flash_attention_tf32x3"] - n["flash_attention_tc"])
        if (n["flash_attention"] != ATTN_PER_FORWARD
                or on_mode != TC_PER_FORWARD):
            raise AssertionError(f"float32 forward with K1 on {mode}: "
                                 f"launches {n}")
    out = {}
    for mode, ms in runs.items():
        med = statistics.median(ms)
        print(f"serve: f32 batch {SERVE_BATCH} forward + fetch, K1 on "
              f"{mode}: median {med:.2f} ms = {SERVE_BATCH / med * 1e3:.1f} "
              f"img/s (runs {ms_list(ms)} ms)", flush=True)
        rule = (reroute(["fwd"], "tf32x3", "simt") if mode == "simt"
                else {})
        profile = profile_device(
            lambda: model(full),
            f"f32 batch {SERVE_BATCH} forward, K1 on {mode}", med)
        restore_rule(rule)
        out[mode] = {"forward_ms": med, "img_per_s": SERVE_BATCH / med * 1e3,
                     "runs_ms": ms, "launches": launches[mode],
                     "profile": profile,
                     "attention_device_ms": attention_ms(profile)}
    return out


def model_weights(loss_cfg, mc) -> dict:
    """The loss weights of the model config ``mc``, as run_training takes
    them."""
    from reftr_torch.models.criterion import weight_dict

    return weight_dict(loss_cfg, mc.dec_layers, mc.aux_loss,
                       with_masks=mc.masks, vision_aux=mc.vision_aux,
                       heatmap_box=mc.heatmap_box)


def train_batch(rng: np.random.Generator, img: int, seq: int, vocab: int,
                b: int):
    """A seeded batch of random canvases with ragged valid regions, token
    ids of length 5-``seq`` and one target box per row, as numpy dicts."""
    valid = np.zeros((b, img, img), bool)
    for i in range(b):
        vh, vw = (int(x) for x in rng.integers(img // 2, img + 1, size=2))
        valid[i, :vh, :vw] = True
    sentence = np.zeros((b, seq), np.int32)
    sentence_valid = np.zeros((b, seq), np.int32)
    for i in range(b):
        n = int(rng.integers(5, seq + 1))
        sentence[i, :n] = rng.integers(1, vocab, n)
        sentence_valid[i, :n] = 1
    centre = rng.uniform(0.3, 0.7, (b, 1, 2))
    size = rng.uniform(0.1, 0.5, (b, 1, 2))
    batch = {"image": rng.integers(0, 256, (b, img, img, 3), dtype=np.uint8),
             "image_valid": valid, "sentence": sentence,
             "sentence_valid": sentence_valid}
    targets = {"boxes": np.concatenate([centre, size], -1).astype(np.float32),
               "box_valid": np.ones((b, 1), bool)}
    return batch, targets


def grad_gap(grads: dict, want: dict, norm: float) -> tuple:
    """The worst relative L2 distance of ``grads`` from ``want`` over the
    trainable tensors, against the larger of the tensor's norm and 1e-4
    of the global ``norm``, and the tensor's name."""
    worst, worst_name = 0.0, ""
    for name, w in want.items():
        err = float((grads[name].double() - w.double()).norm()) / max(
            float(w.norm()), 1e-4 * norm)
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    return worst, worst_name


def compare_train_paths(cfg, batch, targets, label: str = "train",
                        float64: bool = False, check: bool = True,
                        loss_cfg=None) -> dict:
    """One float32 step with dropout 0 from one set of seeded weights,
    through the kernels and through the plain attention: the loss and
    every trainable gradient, and for RES (``masks``) the forward's boxes
    and mask logits. The last layer of bbox_embed, zero at init (no
    gradient would reach the attentions), is drawn like the others. With
    ``float64``, report only: the step once more through the plain
    attention in float64, each float32 path's distance from it, and the
    decoder's FFN pre-activations (linear1's outputs) whose sign differs
    from float64's: one such ReLU flip moves every gradient behind it by
    a whole row's share. ``check`` False reports without the checks.
    ``loss_cfg``: the losses' coefficients (LossConfig's defaults unless
    given); the weights are the model config's (``model_weights``)."""
    import torch

    from reftr_torch.convert import build_model
    from reftr_torch.core.config import LossConfig
    from reftr_torch.models.criterion import criterion, total_loss
    from reftr_torch.nn.attention import set_plain_attention
    from reftr_torch.train.steps import to_device

    mc = dataclasses.replace(
        cfg.model, dtype="float32", dropout=0.0,
        bert=dataclasses.replace(cfg.model.bert, hidden_dropout=0.0,
                                 attention_dropout=0.0))
    model = build_model(mc, seed=1).train()  # on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    with torch.no_grad():
        torch.nn.init.xavier_uniform_(model.bbox_embed.layers[-1].weight,
                                      generator=gen)
    loss_cfg = LossConfig() if loss_cfg is None else loss_cfg
    wd = model_weights(loss_cfg, mc)
    dev_batch = to_device(batch, torch.device("cuda"))
    dev_targets = to_device(targets, torch.device("cuda"))
    pre = {}  # the decoder's FFN pre-activations of the last run
    hooks = [mod.register_forward_hook(
        lambda m, i, o, name=name: pre.__setitem__(name, o.detach().clone()))
        for name, mod in model.named_modules()
        if float64 and name.startswith("vl_transformer.decoder")
        and name.endswith("ffn.linear1")]
    runs, outs, pres = {}, {}, {}
    for plain in (False, True):
        set_plain_attention(model, plain)
        model.zero_grad(set_to_none=True)
        out = model(dev_batch)
        loss = total_loss(criterion(out, dev_targets, loss_cfg,
                                    mc.masks), wd)
        loss.backward()
        pres[plain] = dict(pre)
        outs[plain] = {k: out[k].detach().float() for k in
                       ("pred_boxes", "pred_masks") if k in out}
        runs[plain] = (loss.item(), {n: p.grad.clone() for n, p in
                                     model.named_parameters()
                                     if p.requires_grad})
    (loss_k, grads_k), (loss_p, grads_p) = runs[False], runs[True]
    norm = math.sqrt(sum(float(g.square().sum()) for g in grads_p.values()))
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    live = sum(float(gp.norm()) > 1e-4 * norm for gp in grads_p.values())
    worst, worst_name = grad_gap(grads_k, grads_p, norm)
    print(f"{label}: f32 step, kernels vs plain attention: loss "
          f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.3g}, tol "
          f"{TRAIN_LOSS_TOL}); worst gradient rel L2 {worst:.3g} at "
          f"{worst_name} (tol {TRAIN_GRAD_TOL}) over {len(grads_p)} "
          f"trainable tensors, {live} of them above the floor; global norm "
          f"{norm:.4g}", flush=True)
    gap = None
    if float64:
        model.double()
        model.dtype = torch.float64  # uint8 canvases normalise to it
        set_plain_attention(model, True)
        model.zero_grad(set_to_none=True)
        b64, t64 = ({k: v.double() if v.is_floating_point() else v
                     for k, v in x.items()} for x in (dev_batch, dev_targets))
        loss64 = total_loss(criterion(model(b64), t64, loss_cfg,
                                      mc.masks), wd)
        loss64.backward()
        grads64 = {n: p.grad for n, p in model.named_parameters()
                   if p.requires_grad}
        gap = {}
        for path, plain in (("kernels", False), ("plain", True)):
            loss, grads = runs[plain]
            g, g_name = grad_gap(grads, grads64, norm)
            flips = {n: (pres[plain][n] > 0) != (h > 0)
                     for n, h in pre.items()}
            gap[path] = {"loss_rel": abs(loss - loss64.item())
                         / abs(loss64.item()), "worst_grad_rel_l2": g,
                         "worst_grad_name": g_name,
                         "decoder_relu_flips": {
                             n: int(f.sum()) for n, f in flips.items()
                             if f.any()},
                         "flipped_min_abs_float64": min(
                             (float(pre[n][f].abs().min())
                              for n, f in flips.items() if f.any()),
                             default=None)}
        print(f"{label}: from the plain attention in float64 (report "
              f"only): {gap}", flush=True)
    for hook in hooks:
        hook.remove()
    if not check:
        return {"loss_rel_err": loss_err, "worst_grad_rel_l2": worst,
                "worst_grad_name": worst_name, "from_float64": gap}
    if live < len(grads_p) // 2:
        raise AssertionError(f"only {live} of {len(grads_p)} gradients are "
                             f"above 1e-4 of the global norm: the check "
                             f"would compare nothing")
    if not (loss_err <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"f32 kernel vs plain step: loss rel "
                             f"{loss_err:.3g}, gradient rel L2 {worst:.3g} "
                             f"at {worst_name}")
    result = {"loss_kernel": loss_k, "loss_plain": loss_p,
              "loss_rel_err": loss_err, "worst_grad_rel_l2": worst,
              "worst_grad_name": worst_name, "grad_norm": norm,
              "n_trainable": len(grads_p), "n_above_floor": live,
              "trainable": sorted(grads_p)}
    if gap is not None:
        result["from_float64"] = gap
    if mc.masks:
        box_err = (outs[False]["pred_boxes"]
                   - outs[True]["pred_boxes"]).abs().max().item()
        want = outs[True]["pred_masks"]
        mask_err = ((outs[False]["pred_masks"] - want).norm()
                    / want.norm()).item()
        print(f"{label}: forward, kernels vs plain attention: pred_boxes "
              f"max abs {box_err:.3g} (tol {RES_BOX_TOL}), pred_masks "
              f"{tuple(want.shape)} rel L2 {mask_err:.3g} (tol "
              f"{RES_MASK_TOL})", flush=True)
        if not (box_err <= RES_BOX_TOL and mask_err <= RES_MASK_TOL):
            raise AssertionError(f"f32 RES forward kernel vs plain: boxes "
                                 f"{box_err:.3g}, masks {mask_err:.3g}")
        result.update(pred_boxes_max_abs=box_err, pred_masks_rel_l2=mask_err)
    return result


def train(report: dict, counters) -> dict:
    """Phase 5: refcoco_det training at full width through train_one_epoch."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.core.config import LossConfig, TrainConfig
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.tools.op_profile import profile_device
    from reftr_torch.train.engine import train_one_epoch
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    cfg = preset_config("refcoco_det", dtype="bfloat16")
    mc = cfg.model
    if not (mc.dropout == mc.bert.hidden_dropout
            == mc.bert.attention_dropout == DROPOUT):
        raise AssertionError(f"refcoco_det dropout is not {DROPOUT}")
    batch, targets = train_batch(np.random.default_rng(2), cfg.data.img_size,
                                 cfg.data.max_query_len, mc.bert.vocab_size,
                                 SERVE_BATCH)
    t0 = time.perf_counter()
    # the entry points run on the card by default
    state = TrainState.create(mc, TrainConfig(epochs=1), TRAIN_STEPS, seed=0)
    model = state.model
    wd = weight_dict(LossConfig(), mc.dec_layers, mc.aux_loss)
    step = make_train_step(model, wd, LossConfig())
    n_params = sum(p.numel() for p in state.trainable())
    print(f"train: bf16 autocast over f32 params, {n_params} trainable in "
          f"{len(state.optimizer.param_groups)} groups, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    seen, stamps = [], []

    def traced(state, batch, targets):
        state, metrics = step(state, batch, targets)
        seen.append(metrics)
        stamps.append(time.perf_counter())
        return state, metrics

    reset_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    state, stats = train_one_epoch(traced, state, [(batch, targets)] *
                                   TRAIN_STEPS, 0, print_freq=5,
                                   weight_dict=wd)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = [m.get() for m in seen]
    losses = [m["loss"] for m in per_step]
    norms = [m["grad_norm"] for m in per_step]
    if not all(math.isfinite(v) for m in per_step for v in m.values()):
        raise AssertionError(f"a loss or gradient norm is not finite: "
                             f"{per_step}")
    first, last = statistics.mean(losses[:3]), statistics.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f"the loss on the memorised batch did not fall:"
                             f" first 3 {first:.5f}, last 3 {last:.5f}")
    # 18 + 12 of each wrapper's 30: none left for the SIMT kernels
    want = expected_launches(TRAIN_STEPS, "bfloat16", True)
    if launches != want:
        raise AssertionError(f"launches {launches} in {TRAIN_STEPS} steps, "
                             f"not {want}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[WARM_STEPS:-1],
                                              stamps[WARM_STEPS + 1:])]
    med = statistics.median(step_ms)
    print(f"train: {TRAIN_STEPS} steps; loss {ms_list(losses)}; grad norm "
          f"{ms_list(norms)}; first 3 mean {first:.4f}, last 3 mean "
          f"{last:.4f}; launches {launches}", flush=True)
    print(f"train: bf16 batch {SERVE_BATCH} step median {med:.2f} ms = "
          f"{SERVE_BATCH / med * 1e3:.1f} img/s (steps {WARM_STEPS + 1}-"
          f"{TRAIN_STEPS}: {ms_list(step_ms)} ms); peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    profile = profile_device(
        lambda: step(state, batch, targets),
        f"bf16 batch {SERVE_BATCH} train step", med, iters=3)
    k3_ab = k3_route_steps(step, state, batch, targets)
    del state, model, step
    torch.cuda.empty_cache()
    paths = compare_train_paths(cfg, batch, targets)
    report["train"] = {
        "steps": TRAIN_STEPS, "launches": launches, "losses": losses,
        "grad_norms": norms, "first3_mean": first, "last3_mean": last,
        "stats": stats, "step_ms": step_ms, "median_step_ms": med,
        "img_per_s": SERVE_BATCH / med * 1e3, "peak_memory_gb": peak_gb,
        "trainable_params": n_params, "profile": profile,
        "k3_route_steps": k3_ab, "f32_kernel_vs_plain": paths}
    return report


def k3_route_steps(step, state, batch, targets) -> dict:
    """Phase 5's bf16 step by the rule (K3 on "wg" at the 440-token
    encoder) and with K3 sent to "tc" there, in K3_AB_TURNS turns of each
    (rule, tc, tc, rule, ...), K3_AB_STEPS steps a turn: ms a step on the
    host's clock, from a synchronize before the turn's first step to one
    after its last. The step is host-bound, so this is what "wg"'s host
    work (its tensor maps and function attribute) costs or saves."""
    import torch

    times = {"rule": [], "tc": []}
    for turn in range(2 * K3_AB_TURNS):
        route = ("rule", "tc", "tc", "rule")[turn % 4]
        rule = reroute(("dkv",), "wg", "tc") if route == "tc" else {}
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(K3_AB_STEPS):
                state, _ = step(state, batch, targets)
            torch.cuda.synchronize()
            times[route].append((time.perf_counter() - t0) * 1e3
                                / K3_AB_STEPS)
        finally:
            restore_rule(rule)
    out = {route: {"turn_ms": t, "median_ms": statistics.median(t)}
           for route, t in times.items()}
    print(f"train: bf16 step, K3 at the encoder by the rule (wg) "
          f"{out['rule']['median_ms']:.2f} ms, on tc "
          f"{out['tc']['median_ms']:.2f} ms (median of {K3_AB_TURNS} turns "
          f"of {K3_AB_STEPS} steps, in turns: rule {ms_list(times['rule'])};"
          f" tc {ms_list(times['tc'])} ms a step)", flush=True)
    return out


def attention_ms(profile: dict):
    """The attention kernels' share of a profiled step (device ms): the
    categories of this module's kernels."""
    if profile.get("device_ms") is None:
        return None
    return sum(ms for cat, ms in profile["by_category_ms"].items()
               if cat.startswith("flash_attn"))


def train_f32(report: dict, counters) -> dict:
    """Phase 5b: refcoco_det training in float32 at full width: float32
    parameters and compute (no autocast), dropout 0.1, AdamW as in phase 5,
    F32_TRAIN_STEPS steps of phase 5's batch through train_one_epoch. Every
    loss and gradient norm finite; K1, K2 and K3 launched 30 times per
    step each, 18 of each (BERT and encoder) on the 3xTF32 kernels and 12
    on the decode kernels, none on SIMT. Reports the median host step
    after WARM_STEPS, one step's device time by category with the
    attention kernels' share, and the same step profiled with K1, K2 and
    K3 sent to the SIMT kernels as before the 3xTF32 kernels (the
    same-run "before")."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.core.config import LossConfig, TrainConfig
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.tools.op_profile import profile_device
    from reftr_torch.train.engine import train_one_epoch
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    cfg = preset_config("refcoco_det", dtype="float32")
    mc = cfg.model
    batch, targets = train_batch(np.random.default_rng(2), cfg.data.img_size,
                                 cfg.data.max_query_len, mc.bert.vocab_size,
                                 SERVE_BATCH)
    state = TrainState.create(mc, TrainConfig(epochs=1), F32_TRAIN_STEPS,
                              seed=0)
    wd = weight_dict(LossConfig(), mc.dec_layers, mc.aux_loss)
    step = make_train_step(state.model, wd, LossConfig())
    seen, stamps = [], []

    def traced(state, batch, targets):
        state, metrics = step(state, batch, targets)
        seen.append(metrics)
        stamps.append(time.perf_counter())
        return state, metrics

    reset_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stamps.append(time.perf_counter())
    state, _ = train_one_epoch(traced, state, [(batch, targets)] *
                               F32_TRAIN_STEPS, 0, print_freq=4,
                               weight_dict=wd)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_step = [m.get() for m in seen]
    if not all(math.isfinite(v) for m in per_step for v in m.values()):
        raise AssertionError(f"float32: a loss or gradient norm is not "
                             f"finite: {per_step}")
    want = expected_launches(F32_TRAIN_STEPS, "float32", True)
    if launches != want:
        raise AssertionError(f"float32: launches {launches} in "
                             f"{F32_TRAIN_STEPS} steps, not {want}")
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[WARM_STEPS:-1],
                                              stamps[WARM_STEPS + 1:])]
    med = statistics.median(step_ms)
    losses = [m["loss"] for m in per_step]
    print(f"train f32: {F32_TRAIN_STEPS} steps; loss {ms_list(losses)}; "
          f"launches {launches}", flush=True)
    print(f"train f32: batch {SERVE_BATCH} step median {med:.2f} ms = "
          f"{SERVE_BATCH / med * 1e3:.1f} img/s (steps {WARM_STEPS + 1}-"
          f"{F32_TRAIN_STEPS}: {ms_list(step_ms)} ms); peak device memory "
          f"{peak_gb:.2f} GB", flush=True)
    profile = profile_device(lambda: step(state, batch, targets),
                             f"f32 batch {SERVE_BATCH} train step", med,
                             iters=3)
    # the same step with K1, K2 and K3 on the SIMT kernels, as the rule
    # sent float32 before the 3xTF32 kernels
    rule = reroute(["fwd", "dq", "dkv"], "tf32x3", "simt")
    reset_counts(counters)
    before = profile_device(
        lambda: step(state, batch, targets),
        f"f32 batch {SERVE_BATCH} train step, K1, K2 and K3 on SIMT", med,
        iters=3)
    restore_rule(rule)
    simt_n = read_counts(counters)
    if (any(simt_n[f"{c.__name__}_tf32x3"] for c in counters)
            or any(simt_n[c.__name__] == simt_n[f"{c.__name__}_dec"]
                   for c in counters)):
        raise AssertionError(f"the SIMT-rule step did not run K1, K2 and K3 "
                             f"on SIMT: launches {simt_n}")
    att, att_before = attention_ms(profile), attention_ms(before)
    k1 = {name: (prof.get("by_category_ms") or {}).get(cat)
          for name, prof, cat in (("tf32x3", profile, "flash_attn_fwd_f32tc"),
                                  ("simt", before, "flash_attn_fwd"))}
    print(f"train f32: attention kernels {att} ms of the step's device time"
          f" {profile.get('device_ms')} ms (K1 on 3xTF32 {k1['tf32x3']} ms);"
          f" with K1, K2 and K3 on SIMT {att_before} of "
          f"{before.get('device_ms')} ms (K1 {k1['simt']} ms)", flush=True)
    del state, step
    torch.cuda.empty_cache()
    report["train_f32"] = {
        "steps": F32_TRAIN_STEPS, "launches": launches, "losses": losses,
        "step_ms": step_ms, "median_step_ms": med,
        "img_per_s": SERVE_BATCH / med * 1e3, "peak_memory_gb": peak_gb,
        "profile": profile, "attention_device_ms": att,
        "k1_device_ms": k1["tf32x3"], "profile_simt": before,
        "attention_device_ms_simt": att_before,
        "k1_device_ms_simt": k1["simt"]}
    return report


class _Tee:
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_cli(argv, counters) -> dict:
    """One call of reftr_torch.cli.main.main(argv) in this process, the
    launch counts set to 0 just before and read just after: its exit
    code, printed output, launches, seconds and peak device memory."""
    import contextlib
    import gc

    import torch

    from reftr_torch.cli.main import main as cli_main

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    reset_counts(counters)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return {"rc": rc, "seconds": time.perf_counter() - t0,
            "launches": read_counts(counters),
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "out": "".join(tee.parts)}


def _floats(pattern: str, text: str) -> list:
    return [float(m) for m in re.findall(pattern, text)]


def log_every_times(out: str, header: str):
    """The ``time:`` and ``data:`` that core/metrics.py::log_every printed
    for one pass of ``header`` ("Epoch: [e]" or "Test:"): its first line
    is the first iteration's, its last line the mean of its window (20),
    which holds every iteration of these 8-batch passes; the mean of the
    others follows from the two. None if the run has no such pass."""
    rows = re.findall(rf"^{re.escape(header)} \[\d+/(\d+)\].*time: "
                      rf"([\d.]+)  data: ([\d.]+)", out, re.M)
    if not rows:
        return None
    n = int(rows[0][0])
    (t0, d0), (t, d) = ([float(x) for x in r[1:]] for r in (rows[0],
                                                             rows[-1]))
    return {"n": n, "time_s": t, "data_s": d, "first_time_s": t0,
            "first_data_s": d0, "rest_time_s": (n * t - t0) / (n - 1),
            "rest_data_s": (n * d - d0) / (n - 1)}


def cli_report(run: dict) -> dict:
    """The numbers a run prints (core/metrics.py::log_every and
    train/loop.py): the host's seconds per train step and per eval batch
    (log_every's "Total time"), the mean ``time:`` and ``data:`` of its
    train epoch and of its eval pass, also without their first
    iteration, the model's build seconds and each checkpoint's bytes and
    save seconds."""
    out = run["out"]
    epochs = re.findall(r"^(Epoch: \[\d+\]) \[0/", out, re.M)
    return {
        "train": log_every_times(out, epochs[0]) if epochs else None,
        "eval": log_every_times(out, "Test:"),
        "train_s_per_step": _floats(
            r"Epoch: \[\d+\] Total time: \S+ \(([\d.]+) s / it\)", out),
        "eval_s_per_batch": _floats(
            r"Test: Total time: \S+ \(([\d.]+) s / it\)", out),
        "build_s": _floats(r"model built in ([\d.]+) s", out),
        "checkpoints": [
            {"name": name, "bytes": int(n), "save_s": float(sec)}
            for name, n, sec in re.findall(
                r"checkpoint (\S+): (\d+) bytes saved in ([\d.]+) s", out)],
        "seconds": run["seconds"], "peak_memory_gb": run["peak_memory_gb"]}


def cli_launches(steps: int, eval_batches: int) -> dict:
    """The counters after ``steps`` float32 train steps and
    ``eval_batches`` eval forwards: K1 30 a forward, K2 and K3 30 a step,
    18 of each on the 3xTF32 kernels and 12 on the decode kernels."""
    train = expected_launches(steps, "float32", True)
    evals = expected_launches(eval_batches, "float32", False)
    return {k: train[k] + evals[k] for k in train}


def train_cli(report: dict, counters) -> dict:
    """Phase 6: the trainer's entry point, reftr_torch.cli.main.main, on
    refcoco_det at full width in float32 on the synthetic fixture: the
    first epoch, the same command again (an auto-resume at epoch 1, step
    8), and an eval-only pass over the saved checkpoint."""
    import shutil

    shutil.rmtree(CLI_OUT, ignore_errors=True)
    runs = {"epoch0": run_cli(CLI_TRAIN, counters),
            "epoch1": run_cli(CLI_TRAIN, counters),
            "eval": run_cli(CLI_EVAL, counters)}
    for name, run in runs.items():
        if run["rc"] != 0:
            raise AssertionError(f"phase 6 {name}: exit code {run['rc']}")
    if not re.search(rf"Resumed from \S+ at epoch 1, step {CLI_STEPS}\b",
                     runs["epoch1"]["out"]):
        raise AssertionError(f"phase 6: the second run did not auto-resume "
                             f"at epoch 1, step {CLI_STEPS}")
    with open(CLI_OUT / "log.txt") as f:
        log = [json.loads(line) for line in f]
    if [e["epoch"] for e in log] != [0, 1]:
        raise AssertionError(f"phase 6: log.txt epochs "
                             f"{[e['epoch'] for e in log]}, not [0, 1]")
    bad = {k: v for e in log for k, v in e.items()
           if k.startswith(("train_loss", "test_val_loss"))
           and not math.isfinite(v)}
    if bad:
        raise AssertionError(f"phase 6: losses not finite: {bad}")
    for name in ("checkpoint", "synthetic_val_result.json"):
        if not (CLI_OUT / name).is_file():
            raise AssertionError(f"phase 6: no {name}")
    accs = [e["test_val_accuracy_iou0.5"] for e in log]
    if (CLI_OUT / "checkpoint_best").is_file() != (max(accs) > 0):
        raise AssertionError(f"phase 6: checkpoint_best exists: "
                             f"{(CLI_OUT / 'checkpoint_best').is_file()}, "
                             f"accuracies {accs}")
    evals = [json.loads(m) for m in re.findall(
        r"^\[val\] (\{.*\})$", runs["eval"]["out"], re.M)]
    if len(evals) != 1:
        raise AssertionError(f"phase 6: {len(evals)} eval lines")
    got, want = evals[0], log[-1]
    miou_err = abs(got["miou"] - want["test_val_miou"])
    if (got["accuracy_iou0.5"] != want["test_val_accuracy_iou0.5"]
            or not miou_err <= CLI_MIOU_TOL):
        raise AssertionError(f"phase 6: eval-only {got} against epoch 1 "
                             f"{want}")
    wants = {"epoch0": cli_launches(CLI_STEPS, CLI_EVAL_BATCHES),
             "epoch1": cli_launches(CLI_STEPS, CLI_EVAL_BATCHES),
             "eval": cli_launches(0, CLI_EVAL_BATCHES)}
    for name, run in runs.items():
        if run["launches"] != wants[name]:
            raise AssertionError(f"phase 6 {name}: launches "
                                 f"{run['launches']}, not {wants[name]}")
    reports = {name: cli_report(run) for name, run in runs.items()}
    card = report["card"]
    for name, r in reports.items():
        print(f"cli {name} ({card}): s per train step host to host "
              f"{r['train_s_per_step']}, time:/data: {r['train']}; s per "
              f"eval batch {r['eval_s_per_batch']}, time:/data: "
              f"{r['eval']}; model built in {r['build_s']} s; checkpoints "
              f"{r['checkpoints']}; {r['seconds']:.1f} s in all; peak "
              f"device memory {r['peak_memory_gb']:.2f} GB", flush=True)
    keys = ("epoch", "train_loss", "test_val_accuracy_iou0.5",
            "test_val_miou", "epoch_time")
    print(f"cli: log {[{k: e[k] for k in keys} for e in log]}; eval-only "
          f"accuracy {got['accuracy_iou0.5']}, miou {got['miou']} (|err| "
          f"{miou_err:.2e}); launches "
          f"{ {n: r['launches'] for n, r in runs.items()} }", flush=True)
    # the checkpoints (GBs) stay out of chiprun_out/: sizes are reported;
    # phase 7 fine-tunes from "checkpoint" and deletes it
    for path in CLI_OUT.glob("checkpoint?*"):
        path.unlink()
    report["cli"] = {
        "argv_train": CLI_TRAIN, "argv_eval": CLI_EVAL, "log": log,
        "eval_only": got, "eval_only_miou_err": miou_err,
        "launches": {n: r["launches"] for n, r in runs.items()},
        "runs": reports}
    return report


def res_batch(rng: np.random.Generator, img: int, seq: int, vocab: int,
              b: int):
    """``train_batch`` with RES targets: each box's rectangle as its mask
    on the canvas (as the synthetic fixture draws them), all valid."""
    batch, targets = train_batch(rng, img, seq, vocab, b)
    masks = np.zeros((b, img, img), np.float32)
    for i in range(b):
        vh, vw = np.nonzero(batch["image_valid"][i])
        h, w = vh.max() + 1, vw.max() + 1
        cx, cy, bw, bh = targets["boxes"][i, 0] * [w, h, w, h]
        y0, y1 = int(cy - bh / 2), int(cy + bh / 2)
        x0, x1 = int(cx - bw / 2), int(cx + bw / 2)
        masks[i, y0:y1, x0:x1] = 1.0
    targets.update(masks=masks, mask_valid=np.ones(b, bool))
    return batch, targets


def mask_head_conv_split(prof, iters: int) -> dict:
    """The device time per call of the mask head's convolutions at
    160 x 160, forward and backward (the aten ops' kernels, told apart by
    their input size and weight shape, MASK_HEAD_160), as a row of its own
    out of the "convolution" category."""
    total = 0.0
    for ev in prof.events():
        shapes = ev.input_shapes or []
        if ev.name == "aten::convolution" and len(shapes) > 1:
            x, w = shapes[0], shapes[1]
        elif ev.name == "aten::convolution_backward" and len(shapes) > 2:
            x, w = shapes[1], shapes[2]
        else:
            continue
        if (len(x) == 4 and tuple(x[-2:]) == MASK_HEAD_HW
                and tuple(w) in MASK_HEAD_160):
            total += ev.device_time_total / 1e3 / iters
    return {"mask_head_conv_160": ("convolution", total)}


def res_cli_launches(steps: int, eval_batches: int) -> dict:
    """The counters after ``steps`` bf16 RES train steps and
    ``eval_batches`` eval forwards: the REC trunk's 30 of K1 a forward and
    of K2 and K3 a step, 18 of each on the bf16 tensor-core kernels and 12
    on the decode kernels; the heads run no attention kernel."""
    train = expected_launches(steps, "bfloat16", True)
    evals = expected_launches(eval_batches, "bfloat16", False)
    return {k: train[k] + evals[k] for k in train}


def res_finetune(report: dict, counters) -> dict:
    """Phase 7a: the bf16 fine-tune of refcoco_seg from phase 6's
    refcoco_det checkpoint through reftr_torch.cli.main.main, then an
    eval-only pass over its checkpoint."""
    import ast

    runs = {"finetune": run_cli(RES_TRAIN, counters),
            "eval": run_cli(RES_EVAL, counters)}
    for name, run in runs.items():
        if run["rc"] != 0:
            raise AssertionError(f"phase 7 {name}: exit code {run['rc']}")
    out = runs["finetune"]["out"]
    found = re.findall(r"^Missing keys: (\[.*\])$", out, re.M)
    missing = ast.literal_eval(found[0]) if found else []
    heads = {k.split(".")[0] for k in missing}
    if (len(found) != 1 or heads != {"bbox_attention", "mask_head"}
            or re.search(r"^(Unexpected keys|Shape-mismatched)", out, re.M)):
        raise AssertionError(f"phase 7: the stage-1 checkpoint did not load "
                             f"as the RES model's trunk: missing {heads}, "
                             f"{out[-2000:]}")
    with open(RES_OUT / "log.txt") as f:
        log = [json.loads(line) for line in f]
    if [e["epoch"] for e in log] != [0]:
        raise AssertionError(f"phase 7: log.txt epochs "
                             f"{[e['epoch'] for e in log]}, not [0]")
    entry = log[0]
    losses = {k: v for k, v in entry.items()
              if k.startswith(("train_loss", "test_val_loss"))}
    needed = {f"{p}_{t}" for p in ("train_loss", "test_val_loss")
              for t in ("mask", "dice", "bbox", "giou")}
    if not needed <= set(losses) or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"phase 7: losses {losses}")
    if not 0.0 <= entry["test_val_seg_miou"] <= 1.0:
        raise AssertionError(f"phase 7: seg_miou {entry['test_val_seg_miou']}")
    evals = [json.loads(m) for m in re.findall(
        r"^\[val\] (\{.*\})$", runs["eval"]["out"], re.M)]
    if len(evals) != 1:
        raise AssertionError(f"phase 7: {len(evals)} eval lines")
    got = evals[0]
    errs = {k: abs(got[k] - entry[f"test_val_{k}"])
            for k in ("miou", "seg_miou")}
    if (got["accuracy_iou0.5"] != entry["test_val_accuracy_iou0.5"]
            or not max(errs.values()) <= CLI_MIOU_TOL):
        raise AssertionError(f"phase 7: eval-only {got} against the log "
                             f"{entry}")
    wants = {"finetune": res_cli_launches(CLI_STEPS, CLI_EVAL_BATCHES),
             "eval": res_cli_launches(0, CLI_EVAL_BATCHES)}
    for name, run in runs.items():
        if run["launches"] != wants[name]:
            raise AssertionError(f"phase 7 {name}: launches "
                                 f"{run['launches']}, not {wants[name]}")
    reports = {name: cli_report(run) for name, run in runs.items()}
    card = report["card"]
    for name, r in reports.items():
        print(f"res {name} ({card}): s per train step host to host "
              f"{r['train_s_per_step']}, time:/data: {r['train']}; s per "
              f"eval batch {r['eval_s_per_batch']}, time:/data: "
              f"{r['eval']}; model built in {r['build_s']} s; checkpoints "
              f"{r['checkpoints']}; {r['seconds']:.1f} s in all; peak "
              f"device memory {r['peak_memory_gb']:.2f} GB", flush=True)
    keys = ("train_loss", "train_loss_mask", "train_loss_dice",
            "test_val_accuracy_iou0.5", "test_val_miou", "test_val_seg_miou",
            "epoch_time")
    print(f"res: missing keys at the fine-tune's start: {len(missing)} "
          f"under {sorted(heads)}; log {({k: entry[k] for k in keys})}; "
          f"eval-only accuracy {got['accuracy_iou0.5']}, miou "
          f"{got['miou']}, seg_miou {got['seg_miou']} (|err| {errs}); "
          f"launches { {n: r['launches'] for n, r in runs.items()} }",
          flush=True)
    report["res"] = {
        "argv_train": RES_TRAIN, "argv_eval": RES_EVAL, "log": log,
        "missing_keys": len(missing), "eval_only": got,
        "eval_only_errs": errs,
        "launches": {n: r["launches"] for n, r in runs.items()},
        "runs": reports}
    return report


def res_freeze(report: dict, counters, state_dict) -> dict:
    """Phase 7b: float32 refcoco_seg with freeze_reftr and the CEM loss
    from the fine-tuned weights, RES_FREEZE_STEPS steps through
    train_one_epoch: K1 30 a step and K2 and K3 never (the trunk builds no
    graph); every trunk tensor keeps its bytes; the heads move."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.core.checkpoint import load_pretrained_nonstrict
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.train.engine import train_one_epoch
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    cfg = preset_config("refcoco_seg", dtype="float32", freeze_reftr=True,
                        ablation="cem_loss")
    mc = cfg.model
    state = TrainState.create(mc, cfg.train, RES_FREEZE_STEPS, seed=0)
    loaded = load_pretrained_nonstrict(state.model, state_dict, log=print)
    if {k.split(".")[0] for k in loaded["missing"]} != {"cem_block"}:
        raise AssertionError(f"phase 7 freeze: missing {loaded['missing']}")
    heads = ("bbox_attention", "mask_head", "cem_block")
    if {n.split(".")[0] for n in state.param_names()} != set(heads):
        raise AssertionError(f"phase 7 freeze: the optimizer holds "
                             f"{sorted(set(state.param_names()))}")
    before = {n: t.detach().clone()
              for n, t in state.model.state_dict().items()}
    wd = weight_dict(cfg.loss, mc.dec_layers, mc.aux_loss, with_masks=True)
    step = make_train_step(state.model, wd, cfg.loss)
    batch, targets = res_batch(np.random.default_rng(3), cfg.data.img_size,
                               cfg.data.max_query_len, mc.bert.vocab_size,
                               SERVE_BATCH)
    seen = []

    def traced(state, batch, targets):
        state, metrics = step(state, batch, targets)
        seen.append(metrics)
        return state, metrics

    reset_counts(counters)
    state, _ = train_one_epoch(traced, state, [(batch, targets)] *
                               RES_FREEZE_STEPS, 0, print_freq=2,
                               weight_dict=wd)
    torch.cuda.synchronize()
    launches = read_counts(counters)
    per_step = [m.get() for m in seen]
    if not all(math.isfinite(v) and "loss_cem" in m
               for m in per_step for v in m.values()):
        raise AssertionError(f"phase 7 freeze: metrics {per_step}")
    want = expected_launches(RES_FREEZE_STEPS, "float32", False)
    if launches != want:
        raise AssertionError(f"phase 7 freeze: launches {launches}, not "
                             f"{want}")
    after = state.model.state_dict()
    trunk = [n for n in before if n.split(".")[0] not in heads]
    moved_trunk = [n for n in trunk if not torch.equal(before[n], after[n])]
    grads = {n: p.grad for n, p in state.model.named_parameters()
             if n.split(".")[0] in heads}
    moved = {n: not torch.equal(before[n], after[n]) for n in grads}
    # a head tensor with a gradient must move; c1 (a softmax over one
    # query) and c2's bias (a softmax's shift) get none
    stuck = [n for n, g in grads.items()
             if g is not None and g.abs().max() > 0 and not moved[n]]
    per_head = {h: sum(v for n, v in moved.items() if n.startswith(h + "."))
                for h in heads}
    print(f"res freeze: float32 freeze_reftr + cem_loss, {RES_FREEZE_STEPS} "
          f"steps; loss {ms_list([m['loss'] for m in per_step])}, loss_cem "
          f"{ms_list([m['loss_cem'] for m in per_step])}; launches "
          f"{launches}; trunk tensors {len(trunk)}, moved "
          f"{len(moved_trunk)}; head tensors moved {per_head} of "
          f"{ {h: sum(n.startswith(h + '.') for n in grads) for h in heads} }",
          flush=True)
    if moved_trunk or stuck or not all(per_head.values()):
        raise AssertionError(f"phase 7 freeze: trunk moved {moved_trunk}, "
                             f"heads stuck {stuck}, moved {per_head}")
    del state, step
    torch.cuda.empty_cache()
    return {"steps": RES_FREEZE_STEPS, "launches": launches,
            "losses": [m["loss"] for m in per_step],
            "loss_cem": [m["loss_cem"] for m in per_step],
            "trunk_tensors": len(trunk), "head_tensors_moved": per_head}


def res_profile(report: dict, state_dict) -> dict:
    """Phase 7d (report only): one bf16 RES train step at full width from
    the fine-tuned weights, timed host to host after a warm-up and
    profiled by kernel category, the mask head's 160 x 160 convolutions
    on a row of their own."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.tools.op_profile import profile_device
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    cfg = preset_config("refcoco_seg", dtype="bfloat16")
    mc = cfg.model
    torch.cuda.reset_peak_memory_stats()
    state = TrainState.create(mc, cfg.train, 10, state_dict=state_dict)
    wd = weight_dict(cfg.loss, mc.dec_layers, mc.aux_loss, with_masks=True)
    step = make_train_step(state.model, wd, cfg.loss)
    batch, targets = res_batch(np.random.default_rng(4), cfg.data.img_size,
                               cfg.data.max_query_len, mc.bert.vocab_size,
                               SERVE_BATCH)
    stamps = []
    for _ in range(WARM_STEPS + 4):
        state, metrics = step(state, batch, targets)
        metrics.get()
        stamps.append(time.perf_counter())
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[WARM_STEPS - 1:-1],
                                              stamps[WARM_STEPS:])]
    med = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"res: bf16 batch {SERVE_BATCH} RES step median {med:.2f} ms "
          f"(steps {ms_list(step_ms)} ms, each waiting for its metrics); "
          f"peak device memory {peak_gb:.2f} GB", flush=True)
    profile = profile_device(
        lambda: step(state, batch, targets),
        f"bf16 batch {SERVE_BATCH} RES train step", med, iters=3,
        split=mask_head_conv_split)
    del state, step
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "median_step_ms": med,
            "peak_memory_gb": peak_gb, "profile": profile}


def res_serve(report: dict, counters, state_dict) -> dict:
    """Phase 7e: phase 4's six requests through a MicroBatcher over the
    fine-tuned RES model in bf16 and in float32: every request answered
    with a finite box inside its image and a mask of its original size;
    K1 30 a batch."""
    from reftr_torch.cli.presets import preset_config
    from reftr_torch.serve import ServingModel

    out = {}
    for dtype in ("bfloat16", "float32"):
        cfg = preset_config("refcoco_seg", dtype=dtype)
        model = ServingModel(cfg, SERVE_BATCH, state_dict=state_dict)
        reqs = make_requests(np.random.default_rng(0), cfg.data.img_size,
                             cfg.data.max_query_len,
                             cfg.model.bert.vocab_size)
        launches, n_batches, served_s = serve_requests(model, reqs, counters)
        want = expected_launches(n_batches, dtype, False)
        if launches != want:
            raise AssertionError(f"phase 7 serve {dtype}: launches "
                                 f"{launches}, not {want}")
        areas = []
        for i, r in enumerate(reqs):
            for res in r.result:
                h0, w0 = r.orig_hw
                if (res.get("mask_shape") != [h0, w0]
                        or not 0 <= res["mask_area_px"] <= h0 * w0):
                    raise AssertionError(f"phase 7 serve {dtype}: request "
                                         f"{i} {res}")
                areas.append(res["mask_area_px"] / (h0 * w0))
        print(f"res serve {dtype}: {len(reqs)} requests, "
              f"{sum(r.k for r in reqs)} phrases in {n_batches} batches, "
              f"{served_s:.3f} s; every phrase a box and a mask of its "
              f"image's size (mask area shares {ms_list(areas)}); launches "
              f"{launches}", flush=True)
        out[dtype] = {"batches": n_batches, "launches": launches,
                      "served_s": served_s, "mask_area_shares": areas}
        del model
    return out


def train_res(report: dict, counters) -> dict:
    """Phase 7: RES (refcoco_seg) at full width: the bf16 fine-tune from
    phase 6's checkpoint through the entry point and its eval-only pass,
    a float32 freeze_reftr + cem_loss run, one float32 step through the
    kernels and the plain attention, one profiled bf16 step, and
    serving. The checkpoints are deleted after, as in phase 6."""
    import shutil

    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.core.checkpoint import load_checkpoint

    shutil.rmtree(RES_OUT, ignore_errors=True)
    try:
        res_finetune(report, counters)
        state_dict = load_checkpoint(str(RES_OUT / "checkpoint"))["model"]
    finally:
        for path in [*RES_OUT.glob("checkpoint*"),
                     *CLI_OUT.glob("checkpoint*")]:
            path.unlink()
    report["res"]["freeze"] = res_freeze(report, counters, state_dict)
    cfg = preset_config("refcoco_seg", dtype="float32")
    batch, targets = res_batch(np.random.default_rng(2), cfg.data.img_size,
                               cfg.data.max_query_len,
                               cfg.model.bert.vocab_size, SERVE_BATCH)
    report["res"]["f32_kernel_vs_plain"] = compare_train_paths(
        cfg, batch, targets, label="res")
    torch.cuda.empty_cache()
    report["res"]["bf16_step"] = res_profile(report, state_dict)
    report["res"]["serve"] = res_serve(report, counters, state_dict)
    return report


def multi_launches(steps: int, eval_batches: int) -> dict:
    """The counters after ``steps`` bf16 multi-phrase train steps and
    ``eval_batches`` eval forwards of flickr or flickr_roberta
    (MULTI_FORWARD_SITES: 42 of K1 a forward and of each of K1, K2 and K3
    a step, every one on a bf16 tensor-core kernel by the rule)."""
    train = expected_launches(steps, "bfloat16", True, MULTI_FORWARD_SITES)
    evals = expected_launches(eval_batches, "bfloat16", False,
                              MULTI_FORWARD_SITES)
    return {k: train[k] + evals[k] for k in train}


def check_cli_log(phase: str, out_dir: Path) -> dict:
    """The one log line of a one-epoch run, every logged loss finite."""
    with open(out_dir / "log.txt") as f:
        log = [json.loads(line) for line in f]
    if [e["epoch"] for e in log] != [0]:
        raise AssertionError(f"{phase}: log.txt epochs "
                             f"{[e['epoch'] for e in log]}, not [0]")
    bad = {k: v for k, v in log[0].items()
           if k.startswith(("train_loss", "test_val_loss"))
           and not math.isfinite(v)}
    if bad or "train_loss" not in log[0]:
        raise AssertionError(f"{phase}: losses {log[0]}")
    return log[0]


def check_cli_runs(phase: str, runs: dict, wants: dict) -> dict:
    """Exit codes 0 and the exact launches of each run; returns each run's
    printed numbers (cli_report)."""
    for name, run in runs.items():
        if run["rc"] != 0:
            raise AssertionError(f"{phase} {name}: exit code {run['rc']}")
        if run["launches"] != wants[name]:
            raise AssertionError(f"{phase} {name}: launches "
                                 f"{run['launches']}, not {wants[name]}")
    return {name: cli_report(run) for name, run in runs.items()}


def print_cli_reports(tag: str, card: str, reports: dict) -> None:
    for name, r in reports.items():
        print(f"{tag} {name} ({card}): s per train step host to host "
              f"{r['train_s_per_step']}, time:/data: {r['train']}; s per "
              f"eval batch {r['eval_s_per_batch']}, time:/data: "
              f"{r['eval']}; model built in {r['build_s']} s; checkpoints "
              f"{r['checkpoints']}; {r['seconds']:.1f} s in all; peak "
              f"device memory {r['peak_memory_gb']:.2f} GB", flush=True)


def multi_cli(report: dict, counters) -> dict:
    """Phase 8a: multi-phrase flickr at full width through the entry point
    in bf16: one epoch of MULTI_STEPS steps and MULTI_EVAL_BATCHES eval
    batches, then --eval --resume, whose accuracy must equal the log's;
    42 launches of each kernel a step and of K1 an eval batch, all on
    the bf16 tensor-core kernels. The checkpoints are deleted after."""
    import shutil

    shutil.rmtree(MULTI_OUT, ignore_errors=True)
    try:
        runs = {"train": run_cli(MULTI_TRAIN, counters),
                "eval": run_cli(MULTI_EVAL, counters)}
    finally:
        for path in MULTI_OUT.glob("checkpoint*"):
            path.unlink()
    reports = check_cli_runs("phase 8a", runs, {
        "train": multi_launches(MULTI_STEPS, MULTI_EVAL_BATCHES),
        "eval": multi_launches(0, MULTI_EVAL_BATCHES)})
    entry = check_cli_log("phase 8a", MULTI_OUT)
    evals = [json.loads(m) for m in re.findall(
        r"^\[val\] (\{.*\})$", runs["eval"]["out"], re.M)]
    if len(evals) != 1:
        raise AssertionError(f"phase 8a: {len(evals)} eval lines")
    got = evals[0]
    miou_err = abs(got["miou"] - entry["test_val_miou"])
    if (got["accuracy_iou0.5"] != entry["test_val_accuracy_iou0.5"]
            or not miou_err <= CLI_MIOU_TOL):
        raise AssertionError(f"phase 8a: eval-only {got} against the log "
                             f"{entry}")
    with open(MULTI_OUT / "synthetic_multi_val_result.json") as f:
        boxes = json.load(f)
    if len(boxes) != 64 or any(len(b) != 2 for b in boxes.values()):
        raise AssertionError("phase 8a: the result file does not hold two "
                             "boxes for each of the 64 eval items")
    print_cli_reports("multi", report["card"], reports)
    print(f"multi: log {entry}; eval-only accuracy {got['accuracy_iou0.5']},"
          f" miou {got['miou']} (|err| {miou_err:.2e}); launches "
          f"{ {n: r['launches'] for n, r in runs.items()} }", flush=True)
    report["multi"] = {
        "argv_train": MULTI_TRAIN, "argv_eval": MULTI_EVAL, "log": entry,
        "eval_only": got, "eval_only_miou_err": miou_err,
        "launches": {n: r["launches"] for n, r in runs.items()},
        "runs": reports}
    return report


def multi_batch(cfg, n: int, img: int):
    """``n`` items of the multi-phrase fixture at the config's widths and
    ``img`` px, collated into numpy batch dicts."""
    import tempfile

    from reftr_torch.data.datasets import (SyntheticMultiPhraseDataset,
                                           write_synthetic_vocab)
    from reftr_torch.data.loader import collate
    from reftr_torch.data.native import WordPieceTokenizer

    d = cfg.data
    with tempfile.TemporaryDirectory() as tmp:
        tok = WordPieceTokenizer(write_synthetic_vocab(f"{tmp}/vocab.txt"))
    ds = SyntheticMultiPhraseDataset(
        tok, n=n, img_size=img, max_sentence_len=d.max_sentence_len,
        phrase_seq_len=d.phrase_seq_len, max_num_phrases=d.max_num_phrases)
    return collate([ds[i] for i in range(n)])


def multi_sites(report: dict) -> dict:
    """Phase 8b: K1, K2 and K3 against their plain versions at the call
    sites multi-phrase adds (NEW_SITES: BERT over the phrases, the decoder
    at 16 queries, the encoder over 490 tokens) with their masks, in both
    dtypes, without dropout and with 0.1, and the dropout masks exact
    (phase 3's checks and tolerances; no SIMT "before"); then 8c, one
    float32 multi-phrase step through the kernels and through the plain
    attention at phase 5's rule, with each path's distance from the plain
    attention in float64 (report only), and one profiled bf16 step (report
    only)."""
    from reftr_torch.cli.presets import preset_config

    check_training_kernels(report, MULTI_SITES, "multi_kernels",
                           simt_before=False)
    cfg = preset_config("flickr", dtype="float32")
    batch, targets = multi_batch(cfg, cfg.data.batch_size, cfg.data.img_size)
    report["multi"]["f32_kernel_vs_plain"] = compare_train_paths(
        cfg, batch, targets, label="multi", float64=True)
    report["multi"]["profile"] = profile_train_step(
        cfg, batch, targets, f"multi: bf16 batch {cfg.data.batch_size} "
                             f"multi-phrase train step")
    return report


def long_encoder_times(report: dict) -> list:
    """Phase 8d: the times of the float32 K1, K2 and K3 at the four-level
    encoder at B=8 (vl_encoder_4_levels_b8), without dropout and with
    0.1, against SDPA and the bound (bf16's are phase 3d's); no plain
    version (its [B, H, S, S] scores would hold 18.7 GB in float32). The
    kernels are timed by CUDA events around back-to-back calls (cuda_ms):
    at 5-30 ms a call the host's time between launches is hidden, and
    torch.profiler recorded no device activity in most windows of these
    calls on the H100."""
    import torch

    from reftr_torch.kernels.attention import (dkv_variant, dq_variant,
                                               flash_attention,
                                               flash_attn_bwd_dkv,
                                               flash_attn_bwd_dq, fwd_variant)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    site, name, dt = "vl_encoder_4_levels_b8", "float32", torch.float32
    b, sq, sk, h, d = site_shape(site)
    q, k, v, valid = site_inputs(gen, site, dt)
    do = torch.randn(q.shape, device="cuda", generator=gen).to(dt)
    rows = []
    for rate in (0.0, DROPOUT):
        seed = 0x8540 if rate else None
        drop = dict(dropout_rate=rate, seed=seed)
        out, lse = flash_attention(q, k, v, valid, True, **drop)
        bwd = (q, k, v, valid, out, lse, do, rate, seed)
        dq = flash_attn_bwd_dq(*bwd)
        dk, dv = flash_attn_bwd_dkv(*bwd)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(x).all())
                   for x in (out, lse, dq, dk, dv)):
            raise AssertionError(f"phase 8d {site} {name} {rate}: "
                                 f"not finite")
        row = {"site": site, "dtype": name, "dropout": rate, "B": b,
               "Sq": sq, "Sk": sk, "H": h, "D": d,
               "fwd_variant": fwd_variant(sq, sk, dt, d),
               "dq_variant": dq_variant(sq, sk, dt, d),
               "dkv_variant": dkv_variant(sq, sk, dt, d)}
        for what, fn in (
                ("fwd", lambda: flash_attention(q, k, v, valid, **drop)),
                ("dq", lambda: flash_attn_bwd_dq(*bwd)),
                ("dkv", lambda: flash_attn_bwd_dkv(*bwd))):
            row[f"{what}_ms"] = cuda_ms(fn, iters=10, warmup=2)
        row.update(sdpa_times(q, k, v, valid, do, rate))
        for kern in ("flash_attn_fwd", "flash_attn_bwd_dq",
                     "flash_attn_bwd_dkv"):
            row[f"{kern}_bound_ms"], row[f"{kern}_bound_by"] = \
                attention_bound_ms(b, sq, sk, h, d, valid, name, kern, rate)
        rows.append(row)
        print(f"levels kernels {site} {name} dropout {rate}: K1 "
              f"{row['fwd_variant']} {row['fwd_ms']:.4f}, K2 "
              f"{row['dq_variant']} {row['dq_ms']:.4f}, K3 "
              f"{row['dkv_variant']} {row['dkv_ms']:.4f} ms (events, "
              f"back to back); sdpa fwd "
              f"{fmt_ms(row['sdpa_fwd_device_ms'])}, bwd "
              f"{fmt_ms(row['sdpa_bwd_device_ms'])} ms device; bounds "
              f"{row['flash_attn_fwd_bound_ms']:.4f} "
              f"({row['flash_attn_fwd_bound_by']})/"
              f"{row['flash_attn_bwd_dq_bound_ms']:.4f}/"
              f"{row['flash_attn_bwd_dkv_bound_ms']:.4f} ms", flush=True)
        del out, lse, dq, dk, dv
    del q, k, v, do
    torch.cuda.empty_cache()
    return rows


def profile_train_step(cfg, batch, targets, what: str,
                       prepare=None) -> dict:
    """Report only: one bf16 train step of ``cfg`` on one batch after a
    warm-up, host to host (each step waiting for its metrics), its peak
    device memory and its device time by kernel category with the
    attention kernels' share. ``prepare(model)`` runs on the model
    first."""
    import torch

    from reftr_torch.tools.op_profile import profile_device
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    mc = dataclasses.replace(cfg.model, dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    state = TrainState.create(mc, cfg.train, 10, seed=0)
    if prepare is not None:
        prepare(state.model)
    step = make_train_step(state.model, model_weights(cfg.loss, mc),
                           cfg.loss)
    stamps = []
    for _ in range(WARM_STEPS + 4):
        state, metrics = step(state, batch, targets)
        metrics.get()
        stamps.append(time.perf_counter())
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[WARM_STEPS - 1:-1],
                                              stamps[WARM_STEPS:])]
    med = statistics.median(step_ms)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_device(lambda: step(state, batch, targets), what, med,
                             iters=3)
    attn = attention_ms(profile)
    share = None if attn is None else attn / profile["device_ms"]
    print(f"{what}: median {med:.2f} ms (steps {ms_list(step_ms)} ms, each "
          f"waiting for its metrics); peak device memory {peak_gb:.2f} GB; "
          f"attention {fmt_ms(attn)} ms device, share "
          f"{'not measured' if share is None else f'{share:.3f}'}",
          flush=True)
    del state, step
    torch.cuda.empty_cache()
    return {"step_ms": step_ms, "median_step_ms": med,
            "peak_memory_gb": peak_gb, "profile": profile,
            "attention_device_ms": attn, "attention_share": share}


def train_levels(report: dict, counters) -> dict:
    """Phase 8d: refcoco_det at four feature levels (the encoder over
    8540 tokens): the bf16 CLI run (LEVELS_STEPS steps, LEVELS_EVAL_BATCHES
    eval batches; 30 launches of each kernel a step and of K1 an eval
    batch, 18 on the bf16 tensor-core kernels, 12 on the decode kernels),
    a profiled step, K1, K2 and K3 against their plain versions at the
    encoder at B=1 with the masks exact, the masks exact past an element
    offset of 2^32 (the last batch row at B=8), and the B=8 times."""
    import shutil

    import torch

    from reftr_torch.cli.presets import preset_config

    shutil.rmtree(LEVELS_OUT, ignore_errors=True)
    try:
        runs = {"train": run_cli(LEVELS_TRAIN, counters)}
    finally:
        for path in LEVELS_OUT.glob("checkpoint*"):
            path.unlink()
    steps = expected_launches(LEVELS_STEPS, "bfloat16", True, LEVELS_SITES)
    evals = expected_launches(LEVELS_EVAL_BATCHES, "bfloat16", False,
                              LEVELS_SITES)
    reports = check_cli_runs("phase 8d", runs, {
        "train": {k: steps[k] + evals[k] for k in steps}})
    entry = check_cli_log("phase 8d", LEVELS_OUT)
    print_cli_reports("levels", report["card"], reports)
    print(f"levels: log {entry}; launches {runs['train']['launches']}",
          flush=True)
    torch.cuda.empty_cache()
    cfg = preset_config("refcoco_det", num_feature_levels=4)
    batch, targets = train_batch(np.random.default_rng(8), cfg.data.img_size,
                                 cfg.data.max_query_len,
                                 cfg.model.bert.vocab_size, SERVE_BATCH)
    report["levels"] = {
        "argv_train": LEVELS_TRAIN, "log": entry,
        "launches": {"train": runs["train"]["launches"]}, "runs": reports,
        "profile": profile_train_step(
            cfg, batch, targets, f"levels: bf16 batch {SERVE_BATCH} train "
                                 f"step at 4 feature levels")}
    check_training_kernels(report, ("vl_encoder_4_levels",), "levels_kernels",
                           simt_before=False)
    torch.cuda.empty_cache()
    site = "vl_encoder_4_levels_b8"
    b, sq, sk, h, _ = site_shape(site)
    first = b - 1
    if not (first * h * sq * sk < OFFSET_32 < b * h * sq * sk):
        raise AssertionError(f"{site}: the last batch row does not cross "
                             f"an offset of 2^32")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0x232)
    past = {"K1": check_mask_exact(gen, site, DROPOUT, 0x2_0000_0001,
                                   torch.bfloat16, first),
            "K2": check_dq_mask_exact(site, DROPOUT, 0x2_0000_0002,
                                      torch.bfloat16, first),
            "K3": check_dv_mask_exact(site, DROPOUT, 0x2_0000_0003,
                                      torch.bfloat16, first)}
    print(f"levels kernels: K1's, K2's and K3's bf16 dropout masks equal the "
          f"plain Philox mask exactly in batch row {first} of {b} at "
          f"{site}, element offsets {first * h * sq * sk} to "
          f"{b * h * sq * sk - 1} (past {OFFSET_32}): {past} elements",
          flush=True)
    torch.cuda.empty_cache()
    report["levels"]["mask_past_2_32"] = {
        "first_row": first, "first_offset": first * h * sq * sk,
        "last_offset": b * h * sq * sk - 1, "compared": past}
    report["levels"]["b8_times"] = long_encoder_times(report)
    return report


def float64_gap(report: dict) -> dict:
    """Phase 8f, report only: how far the float32 kernels (3xTF32) and
    the plain float32 version are from the plain version in float64 on
    the same inputs, as the keys grow (GAP_KEYS).

    a) K1's output and K2's and K3's gradients (as a share of the largest
    float64 gradient) at B=1, H=8, D=32 with the encoder's key masks
    (new_site_valid), without dropout and with 0.1.
    b) K1's sum alone: q = 0 makes every p exactly 1, so the output is the
    mean of v over the keys, and the kernel's only error is how its
    products are added up (with v exact in tf32, 3xTF32's split of it is
    exact too) or also how v is split (v in float32). v = |randn| makes
    every term positive, so the mean signed error shows a rounding that
    leans one way.
    c) phrase BERT in bf16 (the ulp rule of kernel_tol): the kernel's and
    the plain bf16 version's distance from float64, and how many outputs
    reach 4.
    c') the bf16 tensor-core kernels' sums (bf16_sum_gap): K1's sum alone
    and K3's dV sum, "tc" and "wg" beside the plain bf16 version.
    d) phase 5's float32 refcoco_det step (compare_train_paths) on its
    batch (seed 2) and on another (seed 5), each path against float64,
    with the decoder's ReLU flips: how near a flip brings phase 5's rule
    with 8 decoder rows behind each FFN gradient."""
    import torch

    from reftr_torch.kernels.attention import (attention_bwd_plain,
                                               attention_plain,
                                               flash_attention,
                                               flash_attn_bwd_dkv,
                                               flash_attn_bwd_dq)

    def err(a, b) -> float:
        return (a.double() - b.double()).abs().max().item()

    def gap_list(values) -> str:
        return ", ".join(f"{x:.3g}" for x in values)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0xF64)
    rows = []
    for sk in GAP_KEYS:
        q, k, v = (torch.randn(1, sk, 8, 32, device="cuda", generator=gen)
                   for _ in range(3))
        valid = new_site_valid(gen, 1, sk)
        do = torch.randn(q.shape, device="cuda", generator=gen)
        for rate in (0.0, DROPOUT):
            seed = 0xF64 + sk if rate else None
            drop = dict(dropout_rate=rate, seed=seed)
            out, lse = flash_attention(q, k, v, valid, True, **drop)
            bwd = (q, k, v, valid, out, lse, do, rate, seed)
            kern = (flash_attn_bwd_dq(*bwd), *flash_attn_bwd_dkv(*bwd))
            p32 = attention_plain(q, k, v, valid, **drop)
            g32 = attention_bwd_plain(*bwd)
            p64 = attention_plain(q.double(), k.double(), v.double(), valid,
                                  **drop)
            g64 = attention_bwd_plain(q.double(), k.double(), v.double(),
                                      valid, out.double(), lse.double(),
                                      do.double(), rate, seed)
            scale = max(g.abs().max().item() for g in g64)
            row = {"what": "calls", "Sk": sk, "dropout": rate,
                   "out_max_abs": p64.abs().max().item(),
                   "kernel_out": err(out, p64), "plain_out": err(p32, p64),
                   "grad_scale": scale,
                   "kernel_grads": [err(g, w) / scale
                                    for g, w in zip(kern, g64)],
                   "plain_grads": [err(g, w) / scale
                                   for g, w in zip(g32, g64)]}
            rows.append(row)
            print(f"float64 gap, K1-K3 float32 at S={sk} dropout {rate}: "
                  f"out (max {row['out_max_abs']:.3f}) kernel "
                  f"{row['kernel_out']:.3g}, plain "
                  f"{row['plain_out']:.3g}; dq, dk, dv / {scale:.3g}: "
                  f"kernel {gap_list(row['kernel_grads'])}, plain "
                  f"{gap_list(row['plain_grads'])}", flush=True)
            del p64, g64, p32, g32
            torch.cuda.empty_cache()
        zero = torch.zeros_like(q)
        pos = torch.randn(1, sk, 8, 32, device="cuda", generator=gen).abs()
        exact_v = (pos.view(torch.int32) & ~0x1FFF).view(torch.float32)
        for v_kind, vv in (("tf32-exact", exact_v), ("float32", pos)):
            want = vv.double().mean(1, keepdim=True)
            rel = {}
            for path, got in (
                    ("kernel", flash_attention(zero, k, vv)),
                    ("plain", attention_plain(zero, k, vv))):
                r = (got.double() - want) / want
                rel[path] = (r.mean().item(), r.abs().max().item())
            row = {"what": "sum", "Sk": sk, "v": v_kind,
                   "kernel_mean_rel": rel["kernel"][0],
                   "kernel_max_rel": rel["kernel"][1],
                   "plain_mean_rel": rel["plain"][0],
                   "plain_max_rel": rel["plain"][1]}
            rows.append(row)
            print(f"float64 gap, K1 float32 sum alone (q = 0, v = |randn| "
                  f"{v_kind}) at S={sk}: relative error mean "
                  f"{row['kernel_mean_rel']:.3g}, max "
                  f"{row['kernel_max_rel']:.3g} (plain "
                  f"{row['plain_mean_rel']:.3g}, "
                  f"{row['plain_max_rel']:.3g})", flush=True)
    rows += bf16_sum_gap(gen)
    b, sq, sk, h, d = site_shape("phrase_bert_self")
    q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen)
               .to(torch.bfloat16) for s in (sq, sk, sk))
    valid = new_site_valid(gen, b, sk)
    for rate in (0.0, DROPOUT):
        drop = dict(dropout_rate=rate, seed=5 if rate else None)
        out = flash_attention(q, k, v, valid, **drop)
        pb = attention_plain(q, k, v, valid, **drop)
        p64 = attention_plain(q.double(), k.double(), v.double(), valid,
                              **drop)
        row = {"what": "phrase_bert_bf16", "dropout": rate,
               "out_max_abs": p64.abs().max().item(),
               "n_at_4_or_more": int((p64.abs() >= 4).sum()),
               "kernel_out": err(out, p64), "plain_bf16_out": err(pb, p64)}
        rows.append(row)
        print(f"float64 gap, phrase BERT bf16 dropout {rate}: max |out| "
              f"{row['out_max_abs']:.3f} ({row['n_at_4_or_more']} at 4 or "
              f"more); kernel {row['kernel_out']:.4g}, plain bf16 "
              f"{row['plain_bf16_out']:.4g} from float64", flush=True)
    from reftr_torch.cli.presets import preset_config

    cfg = preset_config("refcoco_det", dtype="float32")
    for batch_seed in (2, 5):
        batch, targets = train_batch(
            np.random.default_rng(batch_seed), cfg.data.img_size,
            cfg.data.max_query_len, cfg.model.bert.vocab_size, SERVE_BATCH)
        row = compare_train_paths(
            cfg, batch, targets, label=f"float64 gap, refcoco_det step, "
                                       f"batch seed {batch_seed}",
            float64=True, check=False)
        rows.append({"what": "refcoco_det_step", "batch_seed": batch_seed,
                     **row})
        torch.cuda.empty_cache()
    report["float64_gap"] = rows
    return rows


def bf16_sum_gap(gen) -> list:
    """Phase 8f c', report only: whether the bf16 tensor-core kernels' sums
    lean one way, against float64, at GAP_KEYS (B=1, H=8, D=32, the first
    n keys valid, n the largest power of 2 up to Sk, so p = 1 / n is exact
    in bf16). K1's sum alone: q = 0 makes every live p 1, so the output is
    the mean of v = |randn| (exact in bf16) over the live keys. K2's dq
    sum: q = 0 and lse = log n make every live p 1 / n, dO and v one-hot
    on head dim 0 make dP = 1 and O = 0 makes di = 0, so ds = 1 / n
    (exact in bf16) and dq_i = scale * the mean of k = |randn| over the
    live keys: one sum over the key sweep, which K2-TC keeps in one
    mma.sync accumulator and K2-wg folds tile by tile with a rounded add.
    K3's dV sum: q = 0, lse = log n and O = 0 (di = 0) make dv_j the sum
    of dO = |randn| over the queries, over n, for each live key. Each by
    "tc", "wg" and the plain version in bf16 (f32 sums, rounded to bf16):
    the mean signed relative error shows a lean, the largest its
    spread."""
    import torch

    from reftr_torch.kernels.attention import (_launch_dkv, _launch_dq,
                                               _launch_fwd,
                                               attention_bwd_plain,
                                               attention_plain)

    bf16 = torch.bfloat16
    rows = []
    for sk in GAP_KEYS:
        n = 2 ** int(math.log2(sk))
        valid = torch.arange(sk, device="cuda")[None] < n
        k = torch.randn(1, sk, 8, 32, device="cuda", generator=gen).to(bf16)
        zero = torch.zeros_like(k)
        v, do = (torch.randn(1, sk, 8, 32, device="cuda", generator=gen)
                 .abs().to(bf16) for _ in range(2))
        lse = torch.full((1, 8, sk), math.log(n), device="cuda")
        kp = torch.randn(1, sk, 8, 32, device="cuda",
                         generator=gen).abs().to(bf16)
        one = torch.zeros_like(k)
        one[..., 0] = 1
        scale = 1.0 / math.sqrt(32)
        dq_args = (zero, kp, one, valid, zero, lse, one, 0.0, None)
        wants = {"K1 sum": v[:, :n].double().mean(1, keepdim=True),
                 "K2 dq sum": kp[:, :n].double().mean(1, keepdim=True)
                 * scale,
                 "K3 dV sum": do.double().sum(1, keepdim=True) / n}
        gots = {"K1 sum": {
            "tc": _launch_fwd("tc", zero, k, v, valid, 0.0, None, False)[0],
            "wg": _launch_fwd("wg", zero, k, v, valid, 0.0, None, False)[0],
            "plain": attention_plain(zero, k, v, valid)},
            "K2 dq sum": {
            "tc": _launch_dq("tc", *dq_args),
            "wg": _launch_dq("wg", *dq_args),
            "plain": attention_bwd_plain(*dq_args)[0]},
            "K3 dV sum": {
            "tc": _launch_dkv("tc", zero, k, v, valid, zero, lse, do, 0.0,
                              None)[1][:, :n],
            "wg": _launch_dkv("wg", zero, k, v, valid, zero, lse, do, 0.0,
                              None, torch.zeros_like(lse))[1][:, :n],
            "plain": attention_bwd_plain(zero, k, v, valid, zero, lse,
                                         do)[2][:, :n]}}
        for what, paths in gots.items():
            row = {"what": "bf16 " + what, "Sk": sk, "live_keys": n}
            for path, got in paths.items():
                r = (got.double() - wants[what]) / wants[what]
                row[f"{path}_mean_rel"] = r.mean().item()
                row[f"{path}_max_rel"] = r.abs().max().item()
            rows.append(row)
            print(f"float64 gap, {what} bf16 at S={sk} ({n} live keys): "
                  f"relative error mean / max: " + "; ".join(
                      f"{path} {row[f'{path}_mean_rel']:.3g} / "
                      f"{row[f'{path}_max_rel']:.3g}" for path in paths),
                  flush=True)
    return rows


def bytes_to_unicode() -> dict:
    """GPT-2's byte -> symbol table of byte-level BPE: printable bytes map
    to themselves, the others to code points from 256 on."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = list(bs)
    n = 0
    for byte in range(256):
        if byte not in bs:
            bs.append(byte)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def train_roberta(report: dict, counters) -> dict:
    """Phase 8e: flickr_roberta (RoBERTa-base's widths: vocabulary 50265,
    514 positions, pad id 1) on the multi-phrase fixture through the
    entry point in bf16, over a byte-level vocabulary written here (the
    256 byte symbols after <s> <pad> </s> <unk>, no merges): ROBERTA_STEPS
    steps and ROBERTA_EVAL_BATCHES eval batches, 42 launches of each
    kernel a step and of K1 an eval batch, every loss finite."""
    import shutil

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.data.native import ByteLevelBPETokenizer

    shutil.rmtree(ROBERTA_OUT, ignore_errors=True)
    vocab_dir = ROBERTA_OUT / "data" / "roberta-base"
    vocab_dir.mkdir(parents=True)
    symbols = ["<s>", "<pad>", "</s>", "<unk>"] + sorted(
        set(bytes_to_unicode().values()))
    (vocab_dir / "vocab.json").write_text(json.dumps(
        {tok: i for i, tok in enumerate(symbols)}))
    (vocab_dir / "merges.txt").write_text("#version: 0.2\n")
    tok = ByteLevelBPETokenizer(str(vocab_dir / "vocab.json"),
                                str(vocab_dir / "merges.txt"))
    bert = preset_config("flickr_roberta").model.bert
    if not (tok.pad_id == bert.pad_token_id == 1 and bert.is_roberta
            and (bert.vocab_size, bert.max_position_embeddings)
            == (50265, 514)):
        raise AssertionError(f"phase 8e: pad id {tok.pad_id}, {bert}")
    try:
        runs = {"train": run_cli(ROBERTA_TRAIN, counters)}
    finally:
        for path in ROBERTA_OUT.glob("checkpoint*"):
            path.unlink()
    reports = check_cli_runs("phase 8e", runs, {"train": multi_launches(
        ROBERTA_STEPS, ROBERTA_EVAL_BATCHES)})
    entry = check_cli_log("phase 8e", ROBERTA_OUT)
    print_cli_reports("roberta", report["card"], reports)
    print(f"roberta: pad id {tok.pad_id}, vocabulary {bert.vocab_size}, "
          f"{bert.max_position_embeddings} positions; log {entry}; launches "
          f"{runs['train']['launches']}", flush=True)
    report["roberta"] = {"argv_train": ROBERTA_TRAIN, "log": entry,
                         "pad_id": tok.pad_id,
                         "launches": {"train": runs["train"]["launches"]},
                         "runs": reports}
    return report


def phase8(report: dict, counters) -> dict:
    """Phase 8: multi-phrase, four feature levels and RoBERTa."""
    import torch

    multi_cli(report, counters)
    torch.cuda.empty_cache()
    multi_sites(report)
    torch.cuda.empty_cache()
    train_levels(report, counters)
    torch.cuda.empty_cache()
    train_roberta(report, counters)
    torch.cuda.empty_cache()
    float64_gap(report)
    return report


# phase 9: data-parallel training (DDP) of refcoco_det at full width.
# 9a: the entry point under the launcher, one NCCL rank, bf16 (the CLI's
# default), 8 steps and one eval of the 64-item val split
DDP_OUT = ROOT / "chiprun_out" / "ddp"
DDP_STEPS = 8
DDP_EVAL_BATCHES = 8
DDP_TRAIN = ["--preset", "refcoco_det", "--dataset", "synthetic",
             "--test_split", "val", "--synthetic_n", "64", "--batch_size",
             "8", "--num_workers", "4", "--epochs", "1", "--output_dir",
             str(DDP_OUT / "cli")]
# 9b: two gloo ranks on the one card, float32, phase 5's batch of 8 halved
DDP_WORLD = 2
# 9c: turns of the bf16 step without and with DDP, steps a turn
DDP_TURNS = 3
DDP_TURN_STEPS = 4
DDP_TIMEOUT = 600  # s, each launch
ADAM_EPS = 1e-8
UPDATE_TOL = 1e-6  # 9b: an update where the gradient is above 100 eps


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_child(kind: str, nproc: int, args: list, log: Path) -> int:
    """``python chip_smoke.py KIND ARGS`` in ``nproc`` ranks through
    ``python -m reftr_torch.tools.launch``, in a session of its own, so
    that a launch cut at DDP_TIMEOUT is stopped with every rank; its
    output goes to ``log``. Returns the launcher's exit code."""
    import os
    import signal

    cmd = [sys.executable, "-m", "reftr_torch.tools.launch",
           "--nproc_per_node", str(nproc), "--coordinator_port",
           str(free_port()), "--", sys.executable,
           str(ROOT / "chip_smoke.py"), kind] + [str(a) for a in args]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    log.parent.mkdir(parents=True, exist_ok=True)
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            return proc.wait(timeout=DDP_TIMEOUT)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise AssertionError(f"phase 9 {kind}: no end in "
                                 f"{DDP_TIMEOUT} s; {log}")


def child_cli(out_json: str, *argv) -> int:
    """9a's rank: reftr_torch.cli.main.main(argv) with the launch counts
    set to 0 just before and read just after, written to ``out_json``
    with the group's backend and world size."""
    import torch

    from reftr_torch.cli.main import main as cli_main
    from reftr_torch.kernels.attention import (flash_attention,
                                               flash_attn_bwd_dkv,
                                               flash_attn_bwd_dq)

    counters = [flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reset_counts(counters)
    rc = cli_main(list(argv))
    torch.cuda.synchronize()
    dist = torch.distributed
    Path(out_json).write_text(json.dumps({
        "rc": rc, "launches": read_counts(counters),
        "backend": dist.get_backend() if dist.is_initialized() else None,
        "world": dist.get_world_size() if dist.is_initialized() else None,
        "device": torch.cuda.current_device(),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return rc


def ddp_cli(report: dict) -> dict:
    """9a: refcoco_det at full width (bf16, dropout 0.1) under DDP over
    NCCL through the launcher, one rank: 8 steps and one eval."""
    import shutil

    shutil.rmtree(DDP_OUT / "cli", ignore_errors=True)
    child_json = DDP_OUT / "cli_child.json"
    log = DDP_OUT / "cli.log"
    t0 = time.perf_counter()
    rc = launch_child("child-cli", 1, [child_json, *DDP_TRAIN], log)
    seconds = time.perf_counter() - t0
    out = log.read_text()
    if rc != 0:
        raise AssertionError(f"phase 9a: exit code {rc}: {out[-3000:]}")
    child = json.loads(child_json.read_text())
    line = "torch.distributed: backend nccl, world size 1, rank 0 on cuda:0"
    if line not in out or (child["backend"], child["world"]) != ("nccl", 1):
        raise AssertionError(f"phase 9a: no NCCL group of one: {child}")
    with open(DDP_OUT / "cli" / "log.txt") as f:
        log_lines = [json.loads(x) for x in f]
    saves = re.findall(r"^checkpoint checkpoint: (\d+) bytes", out, re.M)
    if len(log_lines) != 1 or len(saves) != 1 or not (
            DDP_OUT / "cli" / "checkpoint").is_file():
        raise AssertionError(f"phase 9a: {len(log_lines)} log lines, "
                             f"{len(saves)} checkpoint saves")
    bad = {k: v for k, v in log_lines[0].items()
           if k.startswith(("train_loss", "test_val_loss"))
           and not math.isfinite(v)}
    step_losses = _floats(r"^Epoch: \[0\] \[\d+/\d+\].*?  loss: ([\d.eE+-]+|"
                          r"nan|inf)", out)
    if bad or not all(math.isfinite(v) for v in step_losses):
        raise AssertionError(f"phase 9a: losses not finite: {bad} "
                             f"{step_losses}")
    train = expected_launches(DDP_STEPS, "bfloat16", True)
    evals = expected_launches(DDP_EVAL_BATCHES, "bfloat16", False)
    want = {k: train[k] + evals[k] for k in train}
    if child["launches"] != want:
        raise AssertionError(f"phase 9a: launches {child['launches']}, "
                             f"not {want}")
    run = cli_report({"out": out, "seconds": seconds,
                      "peak_memory_gb": child["peak_memory_gb"]})
    keys = ("train_loss", "train_grad_norm", "test_val_loss",
            "test_val_accuracy_iou0.5", "test_val_miou", "epoch_time")
    logged = [{k: e[k] for k in keys} for e in log_lines]
    print(f"ddp 9a ({report['card']}): NCCL, world 1, cuda:"
          f"{child['device']}; log {logged}; launches "
          f"{child['launches']}; s per train step "
          f"{run['train_s_per_step']}, time:/data: {run['train']}; s per "
          f"eval batch {run['eval_s_per_batch']}; checkpoints "
          f"{run['checkpoints']}; {seconds:.1f} s in all (the launch "
          f"included); peak device memory {child['peak_memory_gb']:.2f} GB",
          flush=True)
    shutil.rmtree(DDP_OUT / "cli")  # the checkpoint: GBs
    report["ddp_cli"] = {"argv": DDP_TRAIN, "log": log_lines,
                         "launches": child["launches"], "run": run}
    return report


def ddp_model(cfg, seed_bbox: bool = True):
    """refcoco_det's model on the card from seed 0, with the last layer of
    bbox_embed drawn as in compare_train_paths (zero at init, it would
    hold every other gradient at zero on a first step)."""
    import torch

    from reftr_torch.core.config import TrainConfig
    from reftr_torch.train.state import TrainState

    state = TrainState.create(cfg.model, TrainConfig(epochs=1), 1, seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    with torch.no_grad():
        torch.nn.init.xavier_uniform_(
            state.model.bbox_embed.layers[-1].weight, generator=gen)
    return state


def k1_digests(run) -> list:
    """``run()`` with every K1 output of the attention modules recorded:
    (Sk, sha256 of its bytes) per call, in order."""
    import hashlib

    from reftr_torch.nn import attention as nn_attention

    calls, flash = [], nn_attention.flash_attention

    def recorded(q, k, v, *args, **kwargs):
        out = flash(q, k, v, *args, **kwargs)
        calls.append((k.shape[1], hashlib.sha256(
            out.detach().float().cpu().numpy().tobytes()).hexdigest()))
        return out

    nn_attention.flash_attention = recorded
    try:
        run()
    finally:
        nn_attention.flash_attention = flash
    return calls


def one_step(cfg, batch, targets, record: bool = False) -> dict:
    """One float32 train step of ``ddp_model`` (DDP's under a process
    group): metrics, the clipped gradients, the update, K1's digests."""
    from reftr_torch.core.config import LossConfig
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.train.steps import make_train_step

    state = ddp_model(cfg)
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()
              if p.requires_grad}
    step = make_train_step(model, weight_dict(
        LossConfig(), cfg.model.dec_layers, cfg.model.aux_loss),
        LossConfig())
    got = {}

    def run():
        got["metrics"] = step(state, batch, targets)[1].get()

    got["k1"] = k1_digests(run) if record else run()
    got["grads"] = {n: p.grad.clone() for n, p in model.named_parameters()
                    if p.requires_grad}
    got["update"] = {n: p.detach() - before[n]
                     for n, p in model.named_parameters() if p.requires_grad}
    return got


def child_pair(out_json: str) -> int:
    """9b's rank: gloo started here on cuda:0 (NCCL refuses two ranks on
    one card), then ``initialize`` leaves it alone. At dropout 0 one DDP
    step on this rank's half of phase 5's batch; at dropout 0.1 one on the
    first half, on both ranks. Rank 0 then leaves the group and checks
    the two ranks against one process: the whole batch at dropout 0, its
    own half at 0.1 from the same generator state."""
    import os

    import torch
    import torch.distributed as dist

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.core import distributed
    from reftr_torch.core.config import TrainConfig

    rank = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=DDP_WORLD)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    assert distributed.initialize(torch.device("cuda", 0))
    assert dist.get_backend() == "gloo"
    cfg = {rate: preset_config("refcoco_det", dtype="float32", dropout=rate)
           for rate in (0.0, DROPOUT)}
    for rate, c in cfg.items():
        c.model.bert.hidden_dropout = c.model.bert.attention_dropout = rate
    mc = cfg[0.0].model
    batch, targets = train_batch(np.random.default_rng(2),
                                 cfg[0.0].data.img_size,
                                 cfg[0.0].data.max_query_len,
                                 mc.bert.vocab_size, SERVE_BATCH)
    half = SERVE_BATCH // DDP_WORLD

    def rows(tree, r):
        return {k: v[r * half:(r + 1) * half] for k, v in tree.items()}

    t0 = time.perf_counter()
    ddp = one_step(cfg[0.0], rows(batch, rank), rows(targets, rank))
    ddp_s = time.perf_counter() - t0
    masked = one_step(cfg[DROPOUT], rows(batch, 0), rows(targets, 0),
                      record=True)
    losses = [None] * DDP_WORLD
    dist.all_gather_object(losses, ddp["metrics"])
    digests = [None] * DDP_WORLD
    dist.all_gather_object(digests, masked["k1"])
    dist.destroy_process_group()
    if rank != 0:
        return 0
    assert not distributed.is_initialized()
    one = one_step(cfg[0.0], batch, targets)
    alone = one_step(cfg[DROPOUT], rows(batch, 0), rows(targets, 0),
                     record=True)
    want = one["metrics"]
    loss = sum(m["loss"] for m in losses) / DDP_WORLD
    loss_err = abs(loss - want["loss"]) / abs(want["loss"])
    norm_err = abs(ddp["metrics"]["grad_norm"] - want["grad_norm"]) / abs(
        want["grad_norm"])
    gnorm = math.sqrt(sum(float(g.square().sum())
                          for g in one["grads"].values()))
    grad_err, grad_name = grad_gap(ddp["grads"], one["grads"], gnorm)
    # Adam's first update is lr * g / (|g| + eps): about lr times the
    # gradient's sign, which rounding picks where a gradient is at
    # rounding level (the decoder's one-key self-attention's k_proj is
    # zero in exact arithmetic). So, as tests/test_torch_train.py holds an
    # update: 1e-6 absolute where the clipped gradient is above 100 Adam
    # eps, elsewhere Adam's bound of a step, 2 lr
    live = sum(float(g.norm()) > 1e-4 * gnorm for g in one["grads"].values())
    lr = TrainConfig().lr
    upd_big, upd_all, upd_name = 0.0, 0.0, ""
    for n, g in one["grads"].items():
        diff = (ddp["update"][n] - one["update"][n]).abs()
        big = g.abs() > 100 * ADAM_EPS
        err = float(diff[big].max()) if big.any() else 0.0
        if err > upd_big:
            upd_big, upd_name = err, n
        upd_all = max(upd_all, float(diff.max()))
    k1 = digests
    differ = [a != b for a, b in zip(k1[0], k1[1])]
    must_differ = [sk > 1 for sk, _ in k1[0]]
    result = {
        "loss_ranks": [m["loss"] for m in losses], "loss_mean": loss,
        "loss_one": want["loss"], "loss_rel_err": loss_err,
        "grad_norm_ddp": ddp["metrics"]["grad_norm"],
        "grad_norm_one": want["grad_norm"], "grad_norm_rel_err": norm_err,
        "worst_grad_rel_l2": grad_err, "worst_grad_name": grad_name,
        "update_max_abs_err": upd_big, "update_worst_name": upd_name,
        "update_max_abs_err_all": upd_all, "lr": lr,
        "n_trainable": len(one["grads"]), "n_above_floor": live,
        "k1_calls": len(k1[0]), "k1_differ": sum(differ),
        "k1_rank0_equals_one_process": k1[0] == alone["k1"],
        "ddp_step_s_first": ddp_s}
    result["ok"] = bool(
        loss_err <= TRAIN_LOSS_TOL and norm_err <= TRAIN_LOSS_TOL
        and grad_err <= TRAIN_GRAD_TOL and upd_big <= UPDATE_TOL
        and upd_all <= 2 * lr and live >= len(one["grads"]) // 2
        and len(k1[0]) == len(k1[1])
        == ATTN_PER_FORWARD and all(d for d, m in zip(differ, must_differ)
                                    if m)
        and result["k1_rank0_equals_one_process"])
    Path(out_json).write_text(json.dumps(result))
    return 0


def ddp_pair(report: dict) -> dict:
    """9b: two gloo ranks on the one card against one process."""
    out = DDP_OUT / "pair.json"
    out.unlink(missing_ok=True)
    log = DDP_OUT / "pair.log"
    rc = launch_child("child-pair", DDP_WORLD, [out], log)
    if rc != 0:
        raise AssertionError(f"phase 9b: exit code {rc}: "
                             f"{log.read_text()[-3000:]}")
    got = json.loads(out.read_text())
    print(f"ddp 9b ({report['card']}): 2 gloo ranks on cuda:0, float32, "
          f"batch {SERVE_BATCH // DDP_WORLD} a rank against one process on "
          f"{SERVE_BATCH}: loss {got['loss_mean']:.7f} (ranks "
          f"{got['loss_ranks']}) vs {got['loss_one']:.7f}, rel "
          f"{got['loss_rel_err']:.3g} (tol {TRAIN_LOSS_TOL}); grad norm "
          f"{got['grad_norm_ddp']:.6g} vs {got['grad_norm_one']:.6g}, rel "
          f"{got['grad_norm_rel_err']:.3g} (tol {TRAIN_LOSS_TOL}); worst "
          f"gradient rel L2 {got['worst_grad_rel_l2']:.3g} at "
          f"{got['worst_grad_name']} (tol {TRAIN_GRAD_TOL}; "
          f"{got['n_above_floor']} of {got['n_trainable']} gradients above "
          f"the floor); update max abs {got['update_max_abs_err']:.3g} at "
          f"{got['update_worst_name']} where the gradient is above 100 "
          f"eps (tol {UPDATE_TOL}), {got['update_max_abs_err_all']:.3g} "
          f"over all (tol 2 lr = {2 * got['lr']:.3g}); dropout "
          f"{DROPOUT} on one half-batch: {got['k1_differ']} of "
          f"{got['k1_calls']} K1 outputs differ between the ranks, rank 0's "
          f"equal one process's bit for bit: "
          f"{got['k1_rank0_equals_one_process']}", flush=True)
    if not got["ok"]:
        raise AssertionError(f"phase 9b: {got}")
    report["ddp_pair"] = got
    return report


def child_times(out_json: str) -> int:
    """9c (report only): in one NCCL rank, phase 5's bf16 step without
    DDP (made before the group exists) and under DDP, in turns: host ms a
    step (the metrics read back), one profile of each (device ms, NCCL's
    all-reduce), peak memory."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.core import distributed
    from reftr_torch.core.config import LossConfig, TrainConfig
    from reftr_torch.models.criterion import weight_dict
    from reftr_torch.tools.op_profile import profile_device
    from reftr_torch.train.loop import train_device
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    dev = train_device("cuda")
    cfg = preset_config("refcoco_det", dtype="bfloat16")
    mc = cfg.model
    batch, targets = train_batch(np.random.default_rng(2), cfg.data.img_size,
                                 cfg.data.max_query_len, mc.bert.vocab_size,
                                 SERVE_BATCH)
    wd = weight_dict(LossConfig(), mc.dec_layers, mc.aux_loss)
    paths = {}
    for name in ("plain", "ddp"):
        if name == "ddp":
            assert distributed.initialize(dev)
            assert torch.distributed.get_backend() == "nccl"
        state = TrainState.create(mc, TrainConfig(epochs=1), 100, seed=0)
        paths[name] = (state, make_train_step(state.model, wd, LossConfig()))
    torch.cuda.synchronize()
    resident_gb = torch.cuda.memory_allocated() / 1e9

    def one(name):
        state, step = paths[name]
        step(state, batch, targets)[1].get()

    for name in paths:
        for _ in range(WARM_STEPS):
            one(name)
    host = {name: [] for name in paths}
    peak = {name: 0.0 for name in paths}
    for _ in range(DDP_TURNS):
        for name in paths:
            for other, (state, _) in paths.items():
                if other != name:  # its gradients out of this turn's peak
                    state.model.zero_grad(set_to_none=True)
            torch.cuda.reset_peak_memory_stats()
            for _ in range(DDP_TURN_STEPS):
                t0 = time.perf_counter()
                one(name)
                host[name].append((time.perf_counter() - t0) * 1e3)
            peak[name] = max(peak[name],
                             torch.cuda.max_memory_allocated() / 1e9)
    result = {"resident_gb_both_states": resident_gb, "host_ms": host,
              "median_host_ms": {n: statistics.median(v)
                                 for n, v in host.items()},
              "peak_memory_gb": peak, "profile": {}}
    for name in paths:
        prof = profile_device(lambda: one(name), f"9c bf16 step, {name}",
                              result["median_host_ms"][name], iters=3)
        result["profile"][name] = prof
    result["ddp_comm"] = ddp_comm_profile(lambda: one("ddp"), 3)
    Path(out_json).write_text(json.dumps(result))
    torch.distributed.destroy_process_group()
    return 0


def ddp_comm_profile(run, iters: int) -> dict:
    """What DDP's communication costs a step, from one profile: the NCCL
    kernels' device ms and count (an all-reduce over one rank may launch
    none), the ``nccl:*`` host ops (count and host ms) and the
    device-to-device copies (count and device ms), a call each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    out = {"nccl_kernels": 0, "nccl_device_ms": 0.0, "dtod_copies": 0,
           "dtod_device_ms": 0.0}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA or ev.device_time_total <= 0:
            continue
        if "nccl" in ev.name.lower():
            out["nccl_kernels"] += 1
            out["nccl_device_ms"] += ev.device_time_total / 1e3
        elif "Memcpy DtoD" in ev.name:
            out["dtod_copies"] += 1
            out["dtod_device_ms"] += ev.device_time_total / 1e3
    out = {k: v / iters for k, v in out.items()}
    out["nccl_host_ops"] = {
        e.key: {"calls": e.count / iters,
                "host_ms": e.cpu_time_total / 1e3 / iters}
        for e in prof.key_averages() if e.key.startswith("nccl:")}
    return out


def ddp_times(report: dict) -> dict:
    """9c (report only): the bf16 step under DDP at world size 1 (NCCL)
    against the step without DDP."""
    out = DDP_OUT / "times.json"
    log = DDP_OUT / "times.log"
    rc = launch_child("child-times", 1, [out], log)
    if rc != 0:
        raise AssertionError(f"phase 9c: exit code {rc}: "
                             f"{log.read_text()[-3000:]}")
    got = json.loads(out.read_text())
    prof = got["profile"]
    dev_ms = {n: p.get("device_ms") for n, p in prof.items()}
    comm = got["ddp_comm"]
    print(f"ddp 9c ({report['card']}): bf16 batch {SERVE_BATCH} step, host "
          f"ms median (turns of {DDP_TURN_STEPS} steps, metrics read back "
          f"each step): without DDP "
          f"{got['median_host_ms']['plain']:.2f}, DDP over NCCL at world 1 "
          f"{got['median_host_ms']['ddp']:.2f}; device ms {dev_ms}; a DDP "
          f"step's NCCL kernels {comm['nccl_kernels']:.0f}, "
          f"{comm['nccl_device_ms']:.4f} ms device, its nccl host ops "
          f"{comm['nccl_host_ops']}, device-to-device copies "
          f"{comm['dtod_copies']:.0f}, {comm['dtod_device_ms']:.4f} ms; "
          f"peak memory GB {got['peak_memory_gb']} (both states resident: "
          f"{got['resident_gb_both_states']:.2f}; the other path's "
          f"gradients freed before each turn)", flush=True)
    report["ddp_times"] = got
    return report


def phase9(report: dict) -> dict:
    """Phase 9: data-parallel training (DDP)."""
    import torch

    torch.cuda.empty_cache()
    ddp_cli(report)
    ddp_pair(report)
    ddp_times(report)
    return report


# phase 10: the repo's from-scratch recipe (exps/run_gn_flagship3.sh but its
# TPU stem, --space_to_depth_stem) at full width: refcoco_det's geometry
# (640 px, one level, d=256, 6+6 VL layers, 8 heads, ResNet-50) with
# BERT-tiny, GroupNorm in the backbone, the stem and layer1 trained,
# pre-norm, the vision probe and its loss; bf16 through the entry point
SCRATCH_OUT = ROOT / "chiprun_out" / "scratch"
SCRATCH_MODEL = ["--num_feature_levels", "1", "--dataset", "synthetic",
                 "--train_split", "train", "--test_split", "val",
                 "--synthetic_box_frac", "0.25", "0.5", "--bert_size", "tiny",
                 "--backbone_norm", "group", "--train_stem", "--pre_norm",
                 "--aux_loss", "--bbox_loss_coef", "5", "--vision_aux_loss",
                 "--vision_aux_loss_coef", "2", "--lr", "3e-3",
                 "--lr_backbone", "3e-3", "--lr_schedule", "CosineWarmupLR",
                 "--warm_up_epoch", "5", "--clip_max_norm", "1.0",
                 "--epochs", "120", "--batch_size", "16", "--num_workers", "4",
                 "--seed", "0", "--output_dir", str(SCRATCH_OUT)]
# 10a: the recipe's first 2 epochs of 8 steps (128 items), then --eval
SCRATCH_TRAIN = SCRATCH_MODEL + ["--synthetic_n", "128", "--run_epoch", "2"]
SCRATCH_EVAL = SCRATCH_MODEL + ["--eval", "--resume",
                                str(SCRATCH_OUT / "checkpoint")]
SCRATCH_STEPS = 16
SCRATCH_EVAL_BATCHES = 4  # the 64-item val split at batch 16
# (calls, Sq, Sk, D) of the recipe's attention: BERT-tiny's 2 layers over
# 40 tokens (4 heads of 16), the encoder over 440, the decoder's 6 + 6
SCRATCH_SITES = ((2, 40, 40, 16), (6, 440, 440, 32), (6, 1, 1, 32),
                 (6, 1, 440, 32))
# 10: K1, K2 and K3 against their plain versions at the recipe's sites
# that no earlier phase checks at its batch and head width (NEW_SITES)
SCRATCH_KERNEL_SITES = ("scratch_bert_self", "scratch_vl_encoder_self")
# 10b: steps on one repeated batch of phase 5's 8 rows at a constant LR
SCRATCH_GUARD_STEPS = 20
FEAT_ABSMAX = 1e4  # tests/test_from_scratch.py:111


def scratch_config(*flags):
    """The recipe's RefTRConfig, as the entry point parses it, with more
    ``flags``."""
    from reftr_torch.cli import main as cli

    parser = cli.get_args_parser()
    return cli.args_to_config(parser.parse_args(SCRATCH_MODEL + list(flags)))


def scratch_cli(report: dict, counters) -> dict:
    """Phase 10a: the recipe through the entry point in bf16, two epochs of
    8 steps of its 120, then --eval --resume, whose accuracy must equal the
    log's; 20 launches of each kernel a step and of K1 an eval batch (8 on
    the tensor-core kernels, 12 on the decode kernels); then one step of
    the recipe and of the same with FrozenBN, profiled (the GroupNorms'
    casts), the former also with the backbone channels-last."""
    import shutil

    shutil.rmtree(SCRATCH_OUT, ignore_errors=True)
    runs = {"train": run_cli(SCRATCH_TRAIN, counters),
            "eval": run_cli(SCRATCH_EVAL, counters)}
    train = expected_launches(SCRATCH_STEPS, "bfloat16", True, SCRATCH_SITES)
    evals = expected_launches(2 * SCRATCH_EVAL_BATCHES, "bfloat16", False,
                              SCRATCH_SITES)
    reports = check_cli_runs("phase 10a", runs, {
        "train": {k: train[k] + evals[k] for k in train},
        "eval": expected_launches(SCRATCH_EVAL_BATCHES, "bfloat16", False,
                                  SCRATCH_SITES)})
    # what each step launched, by route: check_cli_runs held the runs to it
    per_step = {k: v for k, v in expected_launches(
        1, "bfloat16", True, SCRATCH_SITES).items() if v}
    with open(SCRATCH_OUT / "log.txt") as f:
        log = [json.loads(line) for line in f]
    if [e["epoch"] for e in log] != [0, 1]:
        raise AssertionError(f"phase 10a: log.txt epochs "
                             f"{[e['epoch'] for e in log]}, not [0, 1]")
    bad = {k: v for e in log for k, v in e.items()
           if k.startswith(("train_loss", "test_val_loss"))
           and not math.isfinite(v)}
    if bad or "train_loss_vision" not in log[0]:
        raise AssertionError(f"phase 10a: losses {log}")
    evals = [json.loads(m) for m in re.findall(
        r"^\[val\] (\{.*\})$", runs["eval"]["out"], re.M)]
    if len(evals) != 1:
        raise AssertionError(f"phase 10a: {len(evals)} eval lines")
    got, want = evals[0], log[-1]
    miou_err = abs(got["miou"] - want["test_val_miou"])
    if (got["accuracy_iou0.5"] != want["test_val_accuracy_iou0.5"]
            or not miou_err <= CLI_MIOU_TOL):
        raise AssertionError(f"phase 10a: eval-only {got} against the log "
                             f"{want}")
    print_cli_reports("scratch", report["card"], reports)
    keys = ("epoch", "train_loss", "train_loss_vision", "train_loss_bbox",
            "test_val_loss", "test_val_accuracy_iou0.5", "test_val_miou")
    print(f"scratch: log {[{k: e.get(k) for k in keys} for e in log]}; "
          f"eval-only accuracy {got['accuracy_iou0.5']}, miou {got['miou']}"
          f" (|err| {miou_err:.2e}); launches a step by route {per_step}; "
          f"launches {({n: r['launches'] for n, r in runs.items()})}",
          flush=True)
    cfg = scratch_config()
    batch, targets = train_batch(np.random.default_rng(3), cfg.data.img_size,
                                 cfg.data.max_query_len,
                                 cfg.model.bert.vocab_size,
                                 cfg.data.batch_size)
    profiles = {}
    # the GroupNorm backbone in both layouts: contiguous NCHW (the
    # port's), and channels-last convolutions, where each GroupNorm's copy
    # in and out also changes the layout (ResNet.channels_last)
    for tag, norm, channels_last in (("group", "group", False),
                                     ("group_channels_last", "group", True),
                                     ("frozen", "frozen", True)):
        def prepare(model, channels_last=channels_last):
            model.img_backbone.channels_last = channels_last

        profiles[tag] = profile_train_step(
            scratch_config("--backbone_norm", norm), batch, targets,
            f"scratch recipe bf16 batch {cfg.data.batch_size} step, "
            f"backbone_norm {norm}, "
            f"{'channels-last' if channels_last else 'NCHW'}", prepare)
    nchw, last = profiles["group"], profiles["group_channels_last"]
    print(f"scratch: GroupNorm backbone, device ms a step NCHW "
          f"{nchw['profile']['device_ms']:.3f} (copy kernels "
          f"{nchw['profile']['copy_kernels_ms']:.3f}), channels-last "
          f"{last['profile']['device_ms']:.3f} (copy kernels "
          f"{last['profile']['copy_kernels_ms']:.3f})", flush=True)
    report["scratch"] = {
        "argv_train": SCRATCH_TRAIN, "argv_eval": SCRATCH_EVAL, "log": log,
        "eval_only": got, "eval_only_miou_err": miou_err,
        "launches": {n: r["launches"] for n, r in runs.items()},
        "runs": reports, "profiles": profiles,
        "launches_per_step": per_step}
    return report


def scratch_guard(report: dict) -> dict:
    """Phase 10b: the overflow guard. SCRATCH_GUARD_STEPS bf16 steps of the
    recipe on one repeated batch at its LR held constant: every loss
    finite, the mean loss of the last 3 below that of the first 3 (phase
    5's rule), and the backbone's output (layer4) below FEAT_ABSMAX in
    magnitude at every step; the same with FrozenBN beside it, report
    only (its losses may go non-finite: the reason for the flags)."""
    import torch

    from reftr_torch.core.config import TrainConfig
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    out = {}
    for norm in ("group", "frozen"):
        cfg = scratch_config("--backbone_norm", norm)
        mc = dataclasses.replace(cfg.model, dtype="bfloat16")
        batch, targets = train_batch(np.random.default_rng(2),
                                     cfg.data.img_size,
                                     cfg.data.max_query_len,
                                     mc.bert.vocab_size, SERVE_BATCH)
        tc = TrainConfig(lr=cfg.train.lr, lr_backbone=cfg.train.lr_backbone,
                         lr_bert=cfg.train.lr_bert, clip_max_norm=1.0,
                         epochs=1, lr_schedule="StepLR", lr_drop=1000)
        state = TrainState.create(mc, tc, SCRATCH_GUARD_STEPS, seed=0)
        feats = []
        hook = state.model.img_backbone.register_forward_hook(
            lambda m, i, o: feats.append(o.detach().abs().amax().float()))
        step = make_train_step(state.model, model_weights(cfg.loss, mc),
                               cfg.loss)
        seen = []
        for _ in range(SCRATCH_GUARD_STEPS):
            state, metrics = step(state, batch, targets)
            seen.append(metrics)
        hook.remove()
        per_step = [m.get() for m in seen]
        losses = [m["loss"] for m in per_step]
        absmax = [float(f) for f in feats]
        first, last = (statistics.mean(losses[:3]),
                       statistics.mean(losses[-3:]))
        out[norm] = {"losses": losses, "first3_mean": first,
                     "last3_mean": last, "layer4_absmax": absmax,
                     "grad_norms": [m["grad_norm"] for m in per_step]}
        print(f"scratch guard {norm} ({report['card']}): "
              f"{SCRATCH_GUARD_STEPS} bf16 steps at lr {tc.lr}, batch "
              f"{SERVE_BATCH}; loss {ms_list(losses)}; first 3 mean "
              f"{first:.4f}, last 3 mean {last:.4f}; layer4 absmax "
              f"{ms_list(absmax)}", flush=True)
        del state, step
        torch.cuda.empty_cache()
    g = out["group"]
    if not all(math.isfinite(v) for v in g["losses"] + g["grad_norms"]):
        raise AssertionError(f"phase 10b: a loss or norm is not finite: {g}")
    if not g["last3_mean"] < g["first3_mean"]:
        raise AssertionError(f"phase 10b: the loss did not fall: {g}")
    if not max(g["layer4_absmax"]) < FEAT_ABSMAX:
        raise AssertionError(f"phase 10b: layer4 absmax "
                             f"{max(g['layer4_absmax'])}")
    report["scratch_guard"] = out
    return report


def scratch_paths(report: dict) -> dict:
    """Phase 10c: one float32 step of the recipe with all seven options
    (also --img_pos_in_stream, --decoder_pos_in_value, --heatmap_box) from
    seeded weights, through the kernels and the plain attention, at phase
    5's rule, over every trainable tensor: the stem's, layer1's, every
    GroupNorm's affine and the probe's among them."""
    cfg = scratch_config("--img_pos_in_stream", "--decoder_pos_in_value",
                         "--heatmap_box")
    batch, targets = train_batch(np.random.default_rng(2), cfg.data.img_size,
                                 cfg.data.max_query_len,
                                 cfg.model.bert.vocab_size, SERVE_BATCH)
    paths = compare_train_paths(cfg, batch, targets, label="scratch",
                                loss_cfg=cfg.loss)
    names = set(paths["trainable"])
    for must in ("img_backbone.conv1.weight", "img_backbone.bn1.weight",
                 "img_backbone.layer1.0.conv1.weight",
                 "img_backbone.layer1.0.bn1.bias",
                 "img_backbone.layer4.2.bn3.weight", "vision_probe.weight"):
        if must not in names:
            raise AssertionError(f"phase 10c: {must} was not compared")
    report["scratch_paths"] = paths
    return report


def scratch_serve(report: dict, counters) -> dict:
    """Phase 10d: phase 4's six requests through a MicroBatcher over 10a's
    checkpoint with --heatmap_box, in bf16: none with ``error`` set, each
    box (the soft-argmax of the probe's heatmap) a cxcywh inside [0, 1] of
    its image; 20 launches of K1 a batch."""
    from reftr_torch.core.checkpoint import load_checkpoint
    from reftr_torch.serve import ServingModel

    cfg = scratch_config("--heatmap_box")
    payload = load_checkpoint(str(SCRATCH_OUT / "checkpoint"),
                              map_location="cuda")
    model = ServingModel(cfg, SERVE_BATCH, state_dict=payload["model"])
    del payload
    reqs = make_requests(np.random.default_rng(0), cfg.data.img_size,
                         cfg.data.max_query_len, cfg.model.bert.vocab_size)
    launches, n_batches, served_s = serve_requests(model, reqs, counters,
                                                   inside=False)
    want = expected_launches(n_batches, "bfloat16", False, SCRATCH_SITES)
    if launches != want:
        raise AssertionError(f"phase 10d: launches {launches}, not {want}")
    boxes = []
    for i, r in enumerate(reqs):
        h0, w0 = r.orig_hw
        for res in r.result:
            x0, y0, x1, y1 = res["box_xyxy"]
            # the server rounds pixels to 2 decimals
            box = ((x0 + x1) / 2 / w0, (y0 + y1) / 2 / h0, (x1 - x0) / w0,
                   (y1 - y0) / h0)
            slack = 0.01 / min(h0, w0)
            if not all(-slack <= v <= 1 + slack for v in box):
                raise AssertionError(f"phase 10d: request {i} box {box}")
            boxes.append(box)
    print(f"scratch serve ({report['card']}): {len(reqs)} requests, "
          f"{len(boxes)} phrases in {n_batches} batches, {served_s:.3f} s, "
          f"0 errors; heatmap boxes cxcywh "
          f"{[tuple(round(v, 3) for v in b) for b in boxes]}; launches "
          f"{launches}", flush=True)
    report["scratch_serve"] = {"batches": n_batches, "launches": launches,
                               "served_s": served_s, "boxes": boxes}
    return report


def phase10(report: dict, counters) -> dict:
    """Phase 10: the from-scratch recipe. First K1 (out and lse), K2 and
    K3 against their plain versions at the recipe's BERT-tiny and encoder
    sites (SCRATCH_KERNEL_SITES) in both dtypes, without dropout and with
    0.1, at phase 3's tolerances, the dropout masks exact, the bf16 calls
    timed; then 10a-d. The checkpoints are deleted after, as in phase 6."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_training_kernels(report, SCRATCH_KERNEL_SITES, "scratch_kernels",
                           simt_before=False, timed_dtypes=("bfloat16",))
    try:
        scratch_cli(report, counters)
        scratch_guard(report)
        scratch_paths(report)
        scratch_serve(report, counters)
    finally:
        for path in SCRATCH_OUT.glob("checkpoint*"):
            path.unlink()
    print(f"scratch: phase 10 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return report


HTTP_BATCH = 16  # the server's static batch (tools/serve.py's default)
HTTP_TIMEOUT_MS = 5.0
HTTP_REQUESTS = 64
HTTP_CLIENTS = 16
HTTP_F32_REQUESTS = 16
# COCO-like image sizes (h, w), cycled over the requests
HTTP_SIZES = ((480, 640), (427, 640), (640, 480), (375, 500))
# a served box against the same rows run straight through ServingModel,
# as a share of the image's side: bf16 rounds every activation (and a
# batch of other rows may take other GEMM tiles: predict's batch of a
# request's phrases against the server's 16 parted by 3.6e-4 on the H100);
# float32 sums alone. The bf16 limit stays below the distance between two
# phrases' boxes on one image (http_serve checks that it does)
HTTP_BOX_TOL = {"bfloat16": 1e-3, "float32": 1e-4}
# 11: K1, K2 and K3 against their plain versions at the server's batch of
# 16 where no earlier phase checks that shape (NEW_SITES)
HTTP_KERNEL_SITES = ("serve_bert_self", "serve_decoder_self",
                     "serve_decoder_cross")
# the box head's last layer, drawn for phase 11 (at init it is zero and
# every box would be the same): logits of this scale keep each box
# inside its image and still move it with the input
BOX_LOGIT_STD = 0.15


def npy_decode(data: bytes) -> np.ndarray:
    """The card's machine has no PIL or cv2: phase 11 sends images as
    .npy bytes, read back here (in place of tools/serve.decode_image)."""
    import io

    return np.load(io.BytesIO(data), allow_pickle=False)


def npy_b64(img: np.ndarray) -> str:
    import base64
    import io

    buf = io.BytesIO()
    np.save(buf, img, allow_pickle=False)
    return base64.b64encode(buf.getvalue()).decode()


class _FileServer:
    """A http.server on 127.0.0.1 over one directory, counting the paths
    it was asked for; ``close`` stops its thread."""

    def __init__(self, root: Path):
        import http.server
        import threading

        asked = self.asked = []

        class Handler(http.server.SimpleHTTPRequestHandler):
            def __init__(self, *a, **kw):
                super().__init__(*a, directory=str(root), **kw)

            def log_message(self, *args):
                pass

            def do_GET(self):
                asked.append(self.path)
                super().do_GET()

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def reference_weights(cfg):
    """refcoco_det's seeded init on the card with the box head's last layer
    drawn (BOX_LOGIT_STD): its state dict."""
    import torch

    from reftr_torch.convert import build_model

    model = build_model(cfg.model, "cuda", seed=0)
    last = model.bbox_embed.layers[-1]
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    with torch.no_grad():
        last.weight.normal_(0.0, BOX_LOGIT_STD / math.sqrt(
            last.weight.shape[1]), generator=g)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    return sd


def pth_round_trip(report: dict, tmp: Path) -> dict:
    """Phase 11a: refcoco_det's weights written under the reference's names
    as a float32 .pth (main_vg.py's wrapper, module.-prefixed; one copy of
    the name map: nn/convert.py::reference_state_dict), served from a
    http.server on 127.0.0.1 and loaded by URL through the hub into a
    fresh model, then again from the cache: every tensor equal to the
    source bit for bit, nothing missing or unexpected, one download."""
    import hashlib
    import os

    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.convert import build_model
    from reftr_torch.core import hub
    from reftr_torch.nn.convert import save_reference_checkpoint
    from reftr_torch.train.loop import load_pretrained

    cfg = preset_config("refcoco_det", dtype="bfloat16")
    src = reference_weights(cfg)
    www = tmp / "www"
    www.mkdir()
    t0 = time.perf_counter()
    staged = save_reference_checkpoint(str(www / "staged.pth"), src,
                                       cfg.model)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    h = hashlib.sha256()
    with open(staged, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    sha_s = time.perf_counter() - t0
    # a torch.hub-style name: the hub checks the hash fragment on download
    # and again on every cache hit
    name = f"reftr_refcoco_det-{h.hexdigest()[:10]}.pth"
    os.replace(staged, www / name)
    n_bytes = (www / name).stat().st_size
    os.environ["REFTR_CACHE_DIR"] = str(tmp / "cache")
    files = _FileServer(www)
    url = f"{files.url}/{name}"
    logged = []
    runs = {}
    try:
        t0 = time.perf_counter()
        cached = hub.download_checkpoint(url, logged.append)
        download_s = time.perf_counter() - t0
        for run in ("download", "cache"):
            model = build_model(cfg.model, "cuda", seed=1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = load_pretrained(model, url, cfg, log=logged.append)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            got = model.state_dict()
            diff = [k for k, v in src.items() if not torch.equal(got[k], v)]
            runs[run] = {"report": rep, "load_s": load_s,
                         "unequal": diff, "tensors": len(src)}
            del model, got
            if diff or any(rep.values()):
                raise AssertionError(f"phase 11a ({run}): unequal {diff[:5]}"
                                     f", report {rep}")
    finally:
        files.close()
    if files.asked != [f"/{name}"]:
        raise AssertionError(f"phase 11a: the file server was asked for "
                             f"{files.asked}, not one download")
    print(f"pth ({report['card']}): {name}, {n_bytes} bytes, {len(src)} "
          f"tensors; written in {write_s:.2f} s, sha256 {sha_s:.2f} s, "
          f"download (and its sha256 check) {download_s:.2f} s; convert "
          f"and load from the cache {runs['download']['load_s']:.2f} s, "
          f"again {runs['cache']['load_s']:.2f} s (the hash checked each "
          f"time); every tensor equal bit for bit, nothing missing or "
          f"unexpected; one download ({files.asked})", flush=True)
    report["pth"] = {"name": name, "bytes": n_bytes, "write_s": write_s,
                     "sha256_s": sha_s, "download_s": download_s,
                     "runs": runs, "asked": files.asked,
                     "hub_log": [m for m in logged if "sha256" in m]}
    return {"url": url, "path": cached, "files": www / name}


def http_requests(rng: np.random.Generator, n: int) -> list:
    """``n`` requests of 1-3 phrases over the synthetic vocabulary (and a
    word outside it), on random images of HTTP_SIZES: (image, phrases)."""
    from reftr_torch.data.datasets import SYNTHETIC_VOCAB

    words = SYNTHETIC_VOCAB[4:] + ["zebra"]
    out = []
    for i in range(n):
        h, w = HTTP_SIZES[i % len(HTTP_SIZES)]
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        phrases = [" ".join(rng.choice(words, int(rng.integers(2, 7))))
                   for _ in range(int(rng.integers(1, 4)))]
        out.append((img, phrases))
    return out


def http_call(url: str, payload=None, method: str = "POST") -> tuple:
    """(status, JSON body, seconds) of one request."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            code, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        code, body = e.code, json.loads(e.read())
    return code, body, time.perf_counter() - t0


def direct_boxes(model, frontend, reqs) -> list:
    """The same rows run straight through ``model`` (a ServingModel) on
    canvases the smoke builds (the eval transform and the tokenizer, as
    the front end uses them), packed greedily into batches of the serve
    batch: per request, its boxes in the original image's pixels."""
    import torch

    from reftr_torch.data.transforms import transform_sample
    from reftr_torch.models.postprocess import decode_boxes
    from reftr_torch.serve import Request, pad_batch

    d = frontend.cfg.data
    rows = []
    for img, phrases in reqs:
        ts = transform_sample(img, np.zeros((0, 4), np.float32), d.img_size,
                              d.max_img_size, train=False)
        oh, ow = ts.valid_hw
        valid = np.zeros((d.max_img_size, d.max_img_size), bool)
        valid[:oh, :ow] = True
        for ph in phrases:
            ids, mask, _ = frontend.tokenizer.encode(ph.lower(),
                                                     d.max_query_len)
            rows.append((ts, valid, ids, mask))
    boxes = []
    for i in range(0, len(rows), model.batch_size):
        chunk = rows[i:i + model.batch_size]
        group = [Request(rows={
            "image": ts.canvas[None], "image_valid": valid[None],
            "sentence": ids[None].astype(np.int32),
            "sentence_valid": mask[None].astype(np.int32)}, k=1,
            orig_hw=ts.orig_hw, valid_hw=ts.valid_hw)
            for ts, valid, ids, mask in chunk]
        out = model(pad_batch(group, model.batch_size))
        b = decode_boxes(torch.from_numpy(out["pred_boxes"].astype(
            np.float32)))[:, 0].numpy()
        for j, (ts, _, _, _) in enumerate(chunk):
            h0, w0 = ts.orig_hw
            boxes.append(b[j] * np.array([w0, h0, w0, h0], np.float32))
    out, i = [], 0
    for _, phrases in reqs:
        out.append(boxes[i:i + len(phrases)])
        i += len(phrases)
    return out


def check_answers(label: str, reqs, answers, want, tol: float) -> float:
    """Every answer 200 with one finite box a phrase inside its image,
    within ``tol`` of the image's side of ``want``. Returns the largest
    error as a share of the side."""
    worst = 0.0
    for i, ((img, phrases), (code, body, _), wboxes) in enumerate(
            zip(reqs, answers, want)):
        if code != 200:
            raise AssertionError(f"{label}: request {i} answered {code}: "
                                 f"{body}")
        res = body["results"]
        if [r["phrase"] for r in res] != phrases:
            raise AssertionError(f"{label}: request {i}: {res}")
        h, w = img.shape[:2]
        for r, wb in zip(res, wboxes):
            x0, y0, x1, y1 = r["box_xyxy"]
            if not all(math.isfinite(v) for v in (x0, y0, x1, y1)):
                raise AssertionError(f"{label}: request {i} box {r}")
            if not (0 <= x0 <= x1 <= w and 0 <= y0 <= y1 <= h):
                raise AssertionError(f"{label}: request {i}: box "
                                     f"{r['box_xyxy']} outside {w}x{h}")
            err = float(np.abs(np.array(r["box_xyxy"]) - wb).max())
            worst = max(worst, err / max(h, w))
    if not worst <= tol:
        raise AssertionError(f"{label}: a served box is {worst:.3g} of its "
                             f"image's side from the direct forward's "
                             f"(tol {tol})")
    return worst


def phrase_separation(reqs, want) -> list:
    """For each pair of phrases of one request, the largest coordinate
    difference between their boxes in ``want`` as a share of the image's
    side: how far a swap of the two rows would move an answer."""
    seps = []
    for (img, _), boxes in zip(reqs, want):
        side = max(img.shape[:2])
        seps += [float(np.abs(boxes[i] - boxes[j]).max()) / side
                 for i in range(len(boxes)) for j in range(i + 1,
                                                           len(boxes))]
    return seps


def http_load(base: str, reqs, clients: int, counters, batcher) -> dict:
    """Post ``reqs`` to /predict from ``clients`` threads (each its share
    in order), the launch counts set to 0 just before and read just
    after. Returns the answers and the load's numbers."""
    from concurrent.futures import ThreadPoolExecutor as Pool

    before = dict(batcher.stats)
    payloads = [{"image_b64": npy_b64(img), "phrases": phrases}
                for img, phrases in reqs]
    reset_counts(counters)
    t0 = time.perf_counter()
    with Pool(clients) as pool:
        answers = list(pool.map(lambda p: http_call(base + "/predict", p),
                                payloads))
    wall = time.perf_counter() - t0
    launches = read_counts(counters)
    stats = {k: batcher.stats[k] - before[k] for k in before}
    lat = sorted(a[2] for a in answers)
    rows = sum(len(p) for _, p in reqs)
    return {"answers": answers, "launches": launches,
            "batches": stats["batches"], "requests": stats["requests"],
            "rows": stats["rows"], "sent_requests": len(reqs),
            "sent_rows": rows, "wall_s": wall,
            "requests_per_s": len(reqs) / wall, "rows_per_s": rows / wall,
            "p50_ms": 1e3 * lat[len(lat) // 2],
            "p99_ms": 1e3 * lat[min(len(lat) - 1,
                                    math.ceil(0.99 * len(lat)) - 1)],
            "mean_batch_fill": stats["rows"] / max(1,
                                                   stats["rows_in_batches"])}


def http_serve(report: dict, counters, pth: dict) -> dict:
    """Phase 11b: ``tools/serve.build_server`` in this process on the card,
    refcoco_det at full width with the URL checkpoint, serve batch 16, 5
    ms: 64 requests from one client in sequence, then from 16 clients at
    once; then 16 requests to a float32 server. Checks: every answer 200,
    boxes finite, inside their image and within HTTP_BOX_TOL of the direct
    forward's, the median distance between two phrases' boxes of one
    request above that limit; /healthz, /stats (requests and rows as
    sent); K1 30 a batch
    (18 tc, 12 dec in bf16; 18 tf32x3 in float32), K2 and K3 never; 17
    phrases 500, no phrases 400."""
    import threading

    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.tools import serve as serve_tools
    from reftr_torch.train.loop import build_tokenizer

    decode = serve_tools.decode_image
    serve_tools.decode_image = npy_decode
    print("http: tools/serve.decode_image is a .npy reader in this phase "
          "(no PIL on this machine); the rest of the HTTP path is the "
          "package's", flush=True)
    rng = np.random.default_rng(0)
    reqs = http_requests(rng, HTTP_REQUESTS)
    out = {}
    try:
        for dtype, loads in (("bfloat16", (("sequential", 1, reqs),
                                           ("concurrent", HTTP_CLIENTS,
                                            reqs))),
                             ("float32", (("concurrent", HTTP_CLIENTS,
                                           reqs[:HTTP_F32_REQUESTS]),))):
            cfg = preset_config("refcoco_det", dtype=dtype,
                                dataset="synthetic", resume=pth["url"])
            t0 = time.perf_counter()
            server, batcher = serve_tools.build_server(
                cfg, "127.0.0.1", 0, HTTP_BATCH, HTTP_TIMEOUT_MS)
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            try:
                code, warm, _ = http_call(base + "/predict", {
                    "image_b64": npy_b64(reqs[0][0]),
                    "phrases": reqs[0][1]})
                if code != 200:
                    raise AssertionError(f"http: warm-up {code} {warm}")
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                res = {"build_and_warm_s": build_s, "loads": {}}
                sent = {"requests": 1, "rows": len(reqs[0][1])}
                for label, clients, batch in loads:
                    run = http_load(base, batch, clients, counters, batcher)
                    want_n = expected_launches(run["batches"], dtype, False)
                    if run["launches"] != want_n:
                        raise AssertionError(
                            f"http {dtype} {label}: launches "
                            f"{run['launches']} for {run['batches']} "
                            f"batches, not {want_n}")
                    sent["requests"] += len(batch)
                    sent["rows"] += run["sent_rows"]
                    res["loads"][label] = run
                code, health, _ = http_call(base + "/healthz", method="GET")
                code2, stats, _ = http_call(base + "/stats", method="GET")
                if (code, code2) != (200, 200) or health != {
                        "ok": True, "batch_size": HTTP_BATCH, "masks": False}:
                    raise AssertionError(f"http: healthz {code} {health}")
                if (stats["requests"], stats["rows"]) != (
                        sent["requests"], sent["rows"]):
                    raise AssertionError(f"http: stats {stats}, sent {sent}")
                img = npy_b64(reqs[1][0])
                errors = {
                    "17_phrases": http_call(base + "/predict", {
                        "image_b64": img,
                        "phrases": ["the box"] * (HTTP_BATCH + 1)})[0],
                    "no_phrases": http_call(base + "/predict", {
                        "image_b64": img})[0],
                    "unknown_path": http_call(base + "/nowhere",
                                              method="GET")[0]}
                if errors != {"17_phrases": 500, "no_phrases": 400,
                              "unknown_path": 404}:
                    raise AssertionError(f"http: error codes {errors}")
                # the same rows straight through the server's model, here
                # (the server is idle)
                fe = serve_tools.Frontend(cfg, build_tokenizer(cfg))
                for label, _, batch in loads:
                    want = direct_boxes(batcher.model, fe, batch)
                    run = res["loads"][label]
                    run["preprocess_ms"] = preprocess_ms(fe, batch)
                    run["box_err"] = check_answers(
                        f"http {dtype} {label}", batch, run["answers"], want,
                        HTTP_BOX_TOL[dtype])
                    seps = sorted(phrase_separation(batch, want))
                    run["phrase_separation"] = {
                        "pairs": len(seps), "min": seps[0],
                        "median": seps[len(seps) // 2],
                        "above_tol": sum(x > HTTP_BOX_TOL[dtype]
                                         for x in seps)}
                    if not seps[len(seps) // 2] > HTTP_BOX_TOL[dtype]:
                        raise AssertionError(
                            f"http {dtype} {label}: two phrases' boxes of "
                            f"one request are {run['phrase_separation']} of "
                            f"the side apart, not above the limit "
                            f"{HTTP_BOX_TOL[dtype]}: a swap would pass")
                    if label == "sequential":
                        res["answers"] = [a[1]["results"]
                                          for a in run["answers"]]
                    del run["answers"]
                res.update(stats=stats, errors=errors)
            finally:
                server.shutdown()
                batcher.stop()
                server.server_close()
                th.join(timeout=10)
            del server, batcher
            torch.cuda.empty_cache()
            for label, run in res["loads"].items():
                print(f"http {dtype} {label} ({report['card']}): "
                      f"{run['sent_requests']} requests, {run['sent_rows']} "
                      f"rows in "
                      f"{run['batches']} batches, {run['wall_s']:.3f} s: "
                      f"{run['requests_per_s']:.2f} requests/s, "
                      f"{run['rows_per_s']:.2f} rows/s, p50 "
                      f"{run['p50_ms']:.2f} ms, p99 {run['p99_ms']:.2f} ms, "
                      f"mean_batch_fill {run['mean_batch_fill']:.4f}, "
                      f"Frontend.preprocess {run['preprocess_ms']:.2f} ms "
                      f"a request (alone, after the load); largest box "
                      f"error {run['box_err']:.3g} "
                      f"of the side (tol {HTTP_BOX_TOL[dtype]}); two "
                      f"phrases of one request apart by "
                      f"{run['phrase_separation']} of the side; launches "
                      f"{run['launches']}", flush=True)
            print(f"http {dtype}: server built, weights loaded by URL and "
                  f"warmed in {res['build_and_warm_s']:.1f} s; /stats "
                  f"{res['stats']}; error codes {res['errors']}",
                  flush=True)
            out[dtype] = res
    finally:
        serve_tools.decode_image = decode
    report["http"] = {k: {kk: vv for kk, vv in v.items() if kk != "answers"}
                      for k, v in out.items()}
    return {"reqs": reqs, "answers": out["bfloat16"]["answers"]}


def preprocess_ms(frontend, reqs) -> float:
    """Host ms a request spends in ``frontend.preprocess`` (decode,
    transform, tokenizer), each of ``reqs`` timed alone."""
    payloads = [{"image_b64": npy_b64(img), "phrases": phrases}
                for img, phrases in reqs]
    t0 = time.perf_counter()
    for p in payloads:
        frontend.preprocess(p)
    return 1e3 * (time.perf_counter() - t0) / len(payloads)


def http_predict(report: dict, counters, pth: dict, served: dict,
                 tmp: Path) -> dict:
    """Phase 11c: ``reftr_torch.cli.predict.main`` on the card with the
    .pth path (bf16, the command line's default dtype), on two of 11b's
    images and their phrases: each phrase's box within HTTP_BOX_TOL
    (bf16) of the side of 11b's answer; 30 launches of K1 a call.
    data/datasets._load_image is a .npy reader here (no cv2 or PIL on this
    machine)."""
    import contextlib
    import io

    from reftr_torch.cli import predict
    from reftr_torch.data import datasets

    load = datasets._load_image
    datasets._load_image = lambda path: np.load(path, allow_pickle=False)
    runs = []
    try:
        for i in (0, 2):
            img, phrases = served["reqs"][i]
            path = tmp / f"image{i}.npy"
            np.save(path, img)
            argv = ["--preset", "refcoco_det", "--dataset", "synthetic",
                    "--resume", pth["path"], "--image", str(path)]
            for ph in phrases:
                argv += ["--phrase", ph]
            buf = io.StringIO()
            reset_counts(counters)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = predict.main(argv)
            secs = time.perf_counter() - t0
            launches = read_counts(counters)
            lines = [json.loads(x) for x in buf.getvalue().splitlines()
                     if x.startswith("{")]
            want = expected_launches(1, "bfloat16", False)
            if rc != 0 or launches != want:
                raise AssertionError(f"predict: rc {rc}, launches "
                                     f"{launches}, not {want}")
            side = max(img.shape[:2])
            errs = [float(np.abs(np.array(g["box_xyxy"])
                                 - np.array(w["box_xyxy"])).max()) / side
                    for g, w in zip(lines, served["answers"][i])]
            if ([g["phrase"] for g in lines] != phrases
                    or not max(errs) <= HTTP_BOX_TOL["bfloat16"]):
                raise AssertionError(f"predict: {lines} against 11b's "
                                     f"{served['answers'][i]}")
            runs.append({"request": i, "phrases": len(phrases), "s": secs,
                         "box_err": max(errs), "launches": launches,
                         "lines": lines})
            print(f"predict ({report['card']}): image {img.shape[:2]}, "
                  f"{len(phrases)} phrases in {secs:.2f} s (model build and "
                  f".pth load included); largest error against 11b "
                  f"{max(errs):.3g} of the side; {lines}", flush=True)
    finally:
        datasets._load_image = load
    report["predict"] = runs
    return report


def phase11(report: dict, counters) -> dict:
    """Phase 11: K1 (out and lse), K2 and K3 against their plain versions
    at the server's batch (HTTP_KERNEL_SITES) in both dtypes, without
    dropout and with 0.1, at phase 3's tolerances, the dropout masks
    exact, the bf16 calls timed; then a reference .pth at full width over
    HTTP (11a-c); then phases 12 and 13 on that .pth and 11b's answers.
    The files live in a temporary directory, deleted after."""
    import os
    import tempfile

    t0 = time.perf_counter()
    check_training_kernels(report, HTTP_KERNEL_SITES, "http_kernels",
                           simt_before=False, timed_dtypes=("bfloat16",))
    cache = os.environ.get("REFTR_CACHE_DIR")
    with tempfile.TemporaryDirectory() as d:
        try:
            pth = pth_round_trip(report, Path(d))
            served = http_serve(report, counters, pth)
            http_predict(report, counters, pth, served, Path(d))
            print(f"http: phase 11 in {time.perf_counter() - t0:.1f} s",
                  flush=True)
            phase12(report, counters, pth, served, Path(d))
            phase13(report, counters, pth, served, Path(d))
        finally:
            if cache is None:
                os.environ.pop("REFTR_CACHE_DIR", None)
            else:
                os.environ["REFTR_CACHE_DIR"] = cache
    return report


# 12: the exported serving forward (tools/export_model.py) on the card
EXPORT_BATCH = HTTP_BATCH
# the loaded program against the live ServingModel, pred_boxes max abs:
# JAX's selfcheck limit in float32, phase 11's bf16 limit
EXPORT_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
EXPORT_BATCHES = 2  # counted batches of 12b, each dtype
EXPORT_HTTP_REQUESTS = 16
# 12d: K1 called back to back through the op and through its
# implementation, at BERT-base over 40 tokens at the server's batch and at
# the encoder's 440 at batch 8 (bf16, no dropout), in turns
OP_HOST_SITES = {"bert_base_40": (16, 40, 40, 12, 64),
                 "encoder_440": (8, 440, 440, 8, 32)}
OP_HOST_CALLS = 50
OP_HOST_TURNS = 3
# 12e: --profile_dir on phase 6's entry point: steps 10-14 of epoch 0 are
# traced (train_one_epoch's default), so the epoch has 12 steps
PROFILE_CLI = CLI_MODEL_DATA + ["--synthetic_n", "96", "--epochs", "1"]
PROFILE_CLI_STEPS = 12


def export_batches(reqs, cfg, n: int) -> list:
    """``n`` serve batches of ``reqs``' rows (the front end's canvases and
    token ids, packed greedily and padded to EXPORT_BATCH)."""
    from reftr_torch.serve import pad_batch
    from reftr_torch.tools.serve import Frontend
    from reftr_torch.train.loop import build_tokenizer

    fe = Frontend(cfg, build_tokenizer(cfg))
    batches, group, used = [], [], 0
    for img, phrases in reqs:
        r = fe.rows(img, phrases)
        if used + r.k > EXPORT_BATCH:
            batches.append(pad_batch(group, EXPORT_BATCH))
            group, used = [], 0
            if len(batches) == n:
                break
        group.append(r)
        used += r.k
    return batches


def op_call_recorder():
    """A dispatch mode that keeps, for each call of the K1 op (as the
    loaded program makes it), the inputs' shapes, strides and dtypes and
    the outputs' (``calls``)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    op = torch.ops.reftr.flash_attention_fwd.default

    def meta(x):
        return ((tuple(x.shape), x.stride(), x.dtype)
                if isinstance(x, torch.Tensor) else x)

    class Recorder(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func is op:
                self.calls.append(([meta(a) for a in args],
                                   [meta(t) for t in out]))
            return out

    return Recorder()


def fake_check(calls) -> dict:
    """Each recorded call's outputs against the op's fake (its meta
    kernel) on meta tensors of the same inputs: shape, strides and dtype
    equal. Returns the sites seen, with their calls."""
    import torch

    op = torch.ops.reftr.flash_attention_fwd.default
    sites = {}
    for args, real in calls:
        fake = op(*(torch.empty_strided(a[0], a[1], dtype=a[2],
                                        device="meta")
                    if isinstance(a, tuple) else a for a in args))
        want = [(tuple(t.shape), t.stride(), t.dtype) for t in fake]
        if real != want:
            raise AssertionError(f"export: the op's outputs {real} are not "
                                 f"its fake's {want}")
        (q, _, _), (k, _, _) = args[0], args[1]
        site = (f"Sq={q[1]} Sk={k[1]} H={q[2]} D={q[3]} "
                f"{str(args[0][2]).removeprefix('torch.')}")
        sites[site] = sites.get(site, 0) + 1
    return sites


def export_model_phase(report: dict, counters, pth: dict, tmp: Path,
                       reqs, flags=None, dtypes=("bfloat16", "float32"),
                       key: str = "export") -> dict:
    """Phase 12a-b: refcoco_det exported from phase 11's .pth at the
    server's batch on the card, bf16 and float32 (export, save and load
    seconds, artefact bytes); the loaded program against the live
    ServingModel on the same batches (EXPORT_TOL), K1 exactly 30 a batch
    through it by the rule and K2, K3 and plain none, and at every site
    the op's outputs as its fake gives them. ``flags``: the model config's
    (phase 13b: the folds, whose manifest must say so), under
    report[key]."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.serve import ServingModel, serving_module
    from reftr_torch.tools import export_model

    out = {}
    flags = flags or {}
    for dtype in dtypes:
        cfg = preset_config("refcoco_det", dtype=dtype, dataset="synthetic",
                            **flags)
        spec = export_model.serving_batch_spec(cfg, EXPORT_BATCH)
        t0 = time.perf_counter()
        model = serving_module(cfg, "cuda", resume=pth["path"])
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = export_model.export_serving(model, spec,
                                              torch.device("cuda"))
        export_s = time.perf_counter() - t0
        d = tmp / f"{key}_{dtype}"
        t0 = time.perf_counter()
        manifest = export_model.save_exported(
            program, str(d), export_model.model_manifest(
                cfg, model, EXPORT_BATCH, pth["path"]))
        save_s = time.perf_counter() - t0
        if any(manifest["model"].get(k) != v for k, v in flags.items()):
            raise AssertionError(f"{key} {dtype}: manifest "
                                 f"{manifest['model']}, flags {flags}")
        del model, program
        t0 = time.perf_counter()
        exported = ServingModel(cfg, EXPORT_BATCH, exported_dir=str(d))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        live = ServingModel(cfg, EXPORT_BATCH, resume=pth["path"])
        batches = export_batches(reqs, cfg, EXPORT_BATCHES)
        for b in batches:  # warm-up: the kernels' first calls
            exported(b)
        reset_counts(counters)
        got = [exported(b)["pred_boxes"] for b in batches]
        torch.cuda.synchronize()
        launches = read_counts(counters)
        want_n = expected_launches(len(batches), dtype, False)
        if launches != want_n:
            raise AssertionError(f"{key} {dtype}: launches {launches} for "
                                 f"{len(batches)} batches, not {want_n}")
        want = [live(b)["pred_boxes"] for b in batches]
        err = max(float(np.abs(g.astype(np.float32)
                               - w.astype(np.float32)).max())
                  for g, w in zip(got, want))
        if not err <= EXPORT_TOL[dtype]:
            raise AssertionError(f"{key} {dtype}: pred_boxes {err:.3g} "
                                 f"from the live ServingModel's (tol "
                                 f"{EXPORT_TOL[dtype]})")
        mode = op_call_recorder()
        with mode:
            exported(batches[0])
        torch.cuda.synchronize()
        if len(mode.calls) != ATTN_PER_FORWARD:
            raise AssertionError(f"{key} {dtype}: {len(mode.calls)} op "
                                 f"calls a batch, not {ATTN_PER_FORWARD}")
        sites = fake_check(mode.calls)
        res = {"manifest": {k: manifest[k] for k in (
                   "artifact_bytes", "platforms", "torch_version", "format",
                   "batch_size", "requires", "inputs", "outputs")},
               "build_s": build_s, "export_s": export_s, "save_s": save_s,
               "load_s": load_s, "batches": len(batches),
               "launches": launches, "max_abs_err": err,
               "fake_sites": sites, "dir": str(d)}
        print(f"{key} {dtype} ({report['card']}): model built and .pth "
              f"loaded in {build_s:.2f} s, torch.export {export_s:.2f} s, "
              f"save {save_s:.2f} s ({manifest['artifact_bytes']} bytes), "
              f"load {load_s:.2f} s; {len(batches)} batches of "
              f"{EXPORT_BATCH}: pred_boxes max abs {err:.3g} from the live "
              f"ServingModel (tol {EXPORT_TOL[dtype]}), launches "
              f"{launches}; the op's outputs as its fake gives them at "
              f"{sites}", flush=True)
        out[dtype] = res
        del exported, live
        torch.cuda.empty_cache()
    report[key] = out
    return out


def export_http(report: dict, counters, exported: dict, served: dict
                ) -> dict:
    """Phase 12c: ``tools/serve.build_server(exported_dir=...)`` on the
    bf16 artefact, asked for serve batch 8 (the manifest's 16 must win):
    EXPORT_HTTP_REQUESTS requests from HTTP_CLIENTS clients, every answer
    200 and each box within HTTP_BOX_TOL (bf16) of the image's side of
    phase 11's live server's answer to the same request; /healthz and
    /stats as sent; K1 30 a batch by the rule."""
    import threading

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.tools import serve as serve_tools

    reqs = served["reqs"][:EXPORT_HTTP_REQUESTS]
    want = [[np.array(r["box_xyxy"], np.float32) for r in ans]
            for ans in served["answers"][:EXPORT_HTTP_REQUESTS]]
    cfg = preset_config("refcoco_det", dtype="bfloat16",
                        dataset="synthetic")
    decode = serve_tools.decode_image
    serve_tools.decode_image = npy_decode
    try:
        t0 = time.perf_counter()
        server, batcher = serve_tools.build_server(
            cfg, "127.0.0.1", 0, 8, HTTP_TIMEOUT_MS,
            exported_dir=exported["bfloat16"]["dir"])
        build_s = time.perf_counter() - t0
        th = threading.Thread(target=server.serve_forever, daemon=True)
        th.start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            run = http_load(base, reqs, HTTP_CLIENTS, counters, batcher)
            code, health, _ = http_call(base + "/healthz", method="GET")
            code2, stats, _ = http_call(base + "/stats", method="GET")
        finally:
            server.shutdown()
            batcher.stop()
            server.server_close()
            th.join(timeout=10)
    finally:
        serve_tools.decode_image = decode
    want_n = expected_launches(run["batches"], "bfloat16", False)
    if run["launches"] != want_n:
        raise AssertionError(f"export http: launches {run['launches']} for "
                             f"{run['batches']} batches, not {want_n}")
    if (code, code2) != (200, 200) or health != {
            "ok": True, "batch_size": EXPORT_BATCH, "masks": False}:
        raise AssertionError(f"export http: healthz {code} {health}")
    if (stats["requests"], stats["rows"]) != (len(reqs), run["sent_rows"]):
        raise AssertionError(f"export http: stats {stats}, sent "
                             f"{len(reqs)} requests, {run['sent_rows']} rows")
    run["box_err"] = check_answers("export http", reqs, run.pop("answers"),
                                   want, HTTP_BOX_TOL["bfloat16"])
    run["build_s"] = build_s
    print(f"export http bf16 ({report['card']}): server on the exported "
          f"program built in {build_s:.2f} s, batch {health['batch_size']} "
          f"from the manifest; {run['sent_requests']} requests from "
          f"{HTTP_CLIENTS} clients, {run['batches']} batches in "
          f"{run['wall_s']:.3f} s: {run['requests_per_s']:.2f} requests/s, "
          f"p50 {run['p50_ms']:.2f} ms, p99 {run['p99_ms']:.2f} ms; largest "
          f"box error against phase 11's live server {run['box_err']:.3g} "
          f"of the side; /stats {stats}; launches {run['launches']}",
          flush=True)
    report["export_http"] = run
    return run


def op_host_costs(report: dict, reqs) -> dict:
    """Phase 12d: K1's host time a call through the op
    (torch.ops.reftr.flash_attention_fwd), through its implementation
    called directly (attention._fwd_op_cuda) and through the same
    implementation defined with torch.library.custom_op (the form the op
    does not take), OP_HOST_CALLS back to back, in turns (op, direct,
    custom_op, custom_op, direct, op) OP_HOST_TURNS times: the host's time
    to issue a call and the wall time a call to the last kernel's end;
    then the bf16 batch-8 serving forward's host ms (ServingModel call,
    upload to fetch) with flash_attention on the op and on the direct
    implementation, in turns."""
    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.kernels import attention
    from reftr_torch.serve import ServingModel, pad_batch
    from reftr_torch.tools.serve import Frontend
    from reftr_torch.train.loop import build_tokenizer

    op = torch.ops.reftr.flash_attention_fwd
    gen = torch.Generator(device="cuda").manual_seed(5)
    # the other form torch.library offers, timed beside the op: the same
    # implementation behind custom_op's Python wrapper
    custom = torch.library.custom_op(
        "reftr_smoke::flash_attention_fwd", attention._fwd_op_cuda,
        mutates_args=(), device_types="cuda",
        schema="(Tensor q, Tensor k, Tensor v, Tensor? valid_mask, "
               "float dropout_rate, int? seed, bool return_lse) -> "
               "(Tensor, Tensor)")
    custom.register_fake(attention._fwd_op_fake)
    routes = {"op": op, "direct": attention._fwd_op_cuda,
              "custom_op": custom}

    def issue(fn, args) -> tuple:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OP_HOST_CALLS):
            fn(*args)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return (1e6 * (t1 - t0) / OP_HOST_CALLS,
                1e6 * (t2 - t0) / OP_HOST_CALLS)

    out = {"calls": {}}
    for site, (b, sq, sk, h, d) in OP_HOST_SITES.items():
        q, k, v = (torch.randn(b, s, h, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for s in (sq, sk, sk))
        valid = torch.ones(b, sk, dtype=torch.bool, device="cuda")
        args = (q, k, v, valid, 0.0, None, False)
        for fn in routes.values():
            issue(fn, args)
        runs = {name: [] for name in routes}
        for _ in range(OP_HOST_TURNS):
            for name in ("op", "direct", "custom_op", "custom_op", "direct",
                         "op"):
                runs[name].append(issue(routes[name], args))
        res = {name: {"issue_us": statistics.median(r[0] for r in rs),
                      "wall_us": statistics.median(r[1] for r in rs)}
               for name, rs in runs.items()}
        res["op_cost_us"] = res["op"]["issue_us"] - res["direct"]["issue_us"]
        out["calls"][site] = res
        print(f"op host ({report['card']}): K1 at {site} (B={b}, {sq}x{sk}, "
              f"H={h}, D={d}, bf16), {OP_HOST_CALLS} calls, median of "
              f"{2 * OP_HOST_TURNS} turns each: through the op issue "
              f"{res['op']['issue_us']:.2f} us, wall {res['op']['wall_us']:.2f}"
              f" us a call; the implementation directly issue "
              f"{res['direct']['issue_us']:.2f} us, wall "
              f"{res['direct']['wall_us']:.2f} us; custom_op's form issue "
              f"{res['custom_op']['issue_us']:.2f} us; the op adds "
              f"{res['op_cost_us']:.2f} us a call", flush=True)
    cfg = preset_config("refcoco_det", dtype="bfloat16", dataset="synthetic")
    model = ServingModel(cfg, SERVE_BATCH)
    fe = Frontend(cfg, build_tokenizer(cfg))
    batch = pad_batch([fe.rows(img, phrases[:1])
                       for img, phrases in reqs[:SERVE_BATCH]], SERVE_BATCH)
    forward = attention._forward

    def direct_forward(q, k, v, valid_mask, dropout_rate, seed,
                       return_lse=True):
        o, lse = attention._fwd_op_cuda(q, k, v, valid_mask, dropout_rate,
                                        seed, return_lse)
        return o, (lse if return_lse else None)

    fwd = {"op": [], "direct": []}
    try:
        forward_ms(model, batch, iters=10)
        for _ in range(OP_HOST_TURNS):
            for name in ("op", "direct", "direct", "op"):
                attention._forward = (forward if name == "op"
                                      else direct_forward)
                fwd[name].append(forward_ms(model, batch, iters=10))
    finally:
        attention._forward = forward
    out["forward_ms"] = {k: statistics.median(v) for k, v in fwd.items()}
    out["forward_runs_ms"] = fwd
    print(f"op host ({report['card']}): bf16 batch-{SERVE_BATCH} serving "
          f"forward, host to host, median of {2 * OP_HOST_TURNS} turns of "
          f"10: K1 through the op {out['forward_ms']['op']:.3f} ms, through "
          f"the implementation directly {out['forward_ms']['direct']:.3f} "
          f"ms (op {ms_list(fwd['op'])}; direct {ms_list(fwd['direct'])})",
          flush=True)
    report["op_host"] = out
    del model
    torch.cuda.empty_cache()
    return out


def queued_ms(fn, iters: int = 50) -> float:
    """Device ms a call of ``fn`` by CUDA events, with the host kept out:
    the events and ``iters`` calls are queued behind a sleep kernel long
    enough for the host to queue them all, so the card runs the calls back
    to back (``cuda_ms`` times the host loop where the host is the
    slower)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    # about 20 ms at 1980 MHz: more than the host takes to queue the calls
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_serving_device(report: dict) -> list:
    """Phase 12d: K1 at the server's batch of 16 (HTTP_KERNEL_SITES, bf16,
    no dropout), through flash_attention (the op, its variant by the rule)
    and SDPA on the same inputs and mask: device ms a call by CUDA events
    (``queued_ms``), beside the bound."""
    import torch
    import torch.nn.functional as F

    from reftr_torch.kernels.attention import flash_attention, fwd_variant

    gen = torch.Generator(device="cuda").manual_seed(12)
    rows = []
    for site in HTTP_KERNEL_SITES:
        b, sq, sk, h, d = site_shape(site)
        q, k, v, valid = site_inputs(gen, site, torch.bfloat16)
        bias = torch.where(valid, 0.0, -1e9)[:, None, None, :].to(q.dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with torch.no_grad():
            k1 = queued_ms(lambda: flash_attention(q, k, v, valid))
            sdpa = queued_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=bias))
        bound, by = attention_bound_ms(b, sq, sk, h, d, valid, "bfloat16")
        row = {"site": site, "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
               "variant": fwd_variant(sq, sk, torch.bfloat16, d),
               "device_ms": k1, "sdpa_device_ms": sdpa, "bound_ms": bound,
               "bound_by": by}
        rows.append(row)
        print(f"op host ({report['card']}): K1 {row['variant']} at {site} "
              f"(B={b}, {sq}x{sk}, H={h}, D={d}, bf16): device "
              f"{k1:.4f} ms a call by CUDA events behind a sleep, SDPA "
              f"{sdpa:.4f} ms, bound {bound:.5f} ms ({by})", flush=True)
    report["k1_serving_device"] = rows
    return rows


def profile_tools(report: dict, counters, tmp: Path) -> dict:
    """Phase 12e: op_profile.profile("rec") (its table must name K1's
    kernels), conv_profile.profile()'s stage table, and phase 6's entry
    point once with --profile_dir: a trace written that names a K1
    kernel, 30 launches of each kernel a step and of K1 an eval batch."""
    import glob

    import torch

    from reftr_torch.tools import conv_profile, op_profile

    t0 = time.perf_counter()
    rows = op_profile.profile("rec", topk=15, steps=3)
    k1 = {r["category"]: r for r in rows
          if r["category"].startswith("flash_attn_fwd")}
    if not {"flash_attn_fwd_tc", "flash_attn_fwd_dec"} <= set(k1):
        raise AssertionError(f"op_profile rec: no K1 kernel among "
                             f"{[r['name'][:60] for r in rows[:40]]}")
    op_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stages = conv_profile.profile()
    conv_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    prof_dir = tmp / "profile_dir"
    run = run_cli(PROFILE_CLI + ["--profile_dir", str(prof_dir)], counters)
    want = cli_launches(PROFILE_CLI_STEPS, CLI_EVAL_BATCHES)
    if run["rc"] != 0 or run["launches"] != want:
        raise AssertionError(f"--profile_dir: rc {run['rc']}, launches "
                             f"{run['launches']}, not {want}")
    traces = glob.glob(str(prof_dir / "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile_dir wrote {traces}")
    text = Path(traces[0]).read_text()
    named = sorted({m for m in re.findall(r"flash_fwd_\w+_kernel", text)})
    if not named:
        raise AssertionError("--profile_dir: the trace names no K1 kernel")
    res = {"op_profile_rows": rows[:15],
           "op_profile_k1": {c: {k: r[k] for k in ("name", "ms", "calls")}
                             for c, r in k1.items()},
           "op_profile_s": op_s, "conv_profile": stages, "conv_s": conv_s,
           "profile_dir_trace_bytes": len(text), "profile_dir_k1": named,
           "profile_dir_run_s": run["seconds"]}
    print(f"profile tools ({report['card']}): op_profile rec in {op_s:.1f} s"
          f" (K1: {res['op_profile_k1']}); conv_profile in {conv_s:.1f} s; "
          f"--profile_dir run {run['seconds']:.1f} s wrote "
          f"{len(text)} bytes naming {named}", flush=True)
    report["profile_tools"] = res
    return res


def phase12(report: dict, counters, pth: dict, served: dict,
            tmp: Path) -> dict:
    """Phase 12: export (12a-c), the op's host cost (12d), the profiler
    tools (12e), in phase 11's temporary directory."""
    t0 = time.perf_counter()
    exported = export_model_phase(report, counters, pth, tmp, served["reqs"])
    export_http(report, counters, exported, served)
    op_host_costs(report, served["reqs"])
    k1_serving_device(report)
    profile_tools(report, counters, tmp)
    report["phase12_s"] = time.perf_counter() - t0
    print(f"export: phase 12 in {report['phase12_s']:.1f} s", flush=True)
    return report


# 13: the backbone's folds, the space-to-depth stem and remat on the card
# (the JAX package's serving flags and step knobs), in phase 11's
# temporary directory on its .pth
FOLDS = {"fold_bn": True, "fold_normalize": True}
FOLD_REQUESTS = {"bfloat16": 16, "float32": 8}
FOLD_CLIENTS = 8
# 13a: fold_normalize is exact inside the edge ring its padding taps
# reach: layer1's output HALO pixels in, against the unfolded model's, at
# JAX's fold tolerance (tests/test_resnet.py:248) of the largest magnitude
HALO = 6
FOLD_INTERIOR_TOL = 2e-4
STEP_TURNS = 1  # 13c-e: each configuration's readings, in turns
STEP_ITERS = 2  # profiled steps a turn
STEP_WARM = 2  # steps of each configuration before its readings
S2D = {"space_to_depth_stem": True, "fold_bn": True}
REMAT = {"remat": True, "backbone_remat": True}


def box_gap(reqs, got, want) -> float:
    """The largest coordinate distance between two direct forwards' boxes
    of the same rows, as a share of the image's side."""
    return max(float(np.abs(g - w).max()) / max(img.shape[:2])
               for (img, _), gs, ws in zip(reqs, got, want)
               for g, w in zip(gs, ws))


def interior_gap(folded, unfolded, batch) -> float:
    """layer1's output of two float32 ServingModels' backbones on the same
    uint8 canvases, the folded one (fold_bn, fold_normalize) on them as
    they are and the unfolded one normalising them, HALO pixels in from
    the edge: the largest difference over the unfolded output's largest
    magnitude (at least 1), as tests/test_resnet.py:248 holds it."""
    import torch

    from reftr_torch.ops.image import normalize_images

    img = torch.from_numpy(batch["image"]).cuda()
    fb, ub = folded.model.img_backbone, unfolded.model.img_backbone
    with torch.inference_mode():
        got = fb.run_stage(1, fb.stem(img.float()))
        want = ub.run_stage(1, ub.stem(normalize_images(img)))
    inner = (slice(None), slice(None), slice(HALO, -HALO),
             slice(HALO, -HALO))
    err = (got[inner] - want[inner]).abs().max()
    return float(err / want[inner].abs().max().clamp(min=1.0))


def fold_http(report: dict, counters, pth: dict, served: dict) -> dict:
    """Phase 13a: phase 11's .pth by URL through tools/serve.build_server
    with --fold_bn --fold_normalize (serve batch 16, FOLD_REQUESTS of 11b's
    requests from FOLD_CLIENTS clients), bf16 and float32. Checks: every
    answer 200, inside its image and within HTTP_BOX_TOL of the server's
    own model run directly on the same rows; K1 30 a batch by the rule,
    K2 and K3 never; the same rows through the unfolded model and the
    fold_bn-only model (both loading the .pth): the fold_bn-only boxes
    within HTTP_BOX_TOL of the unfolded model's (fold_bn is exact). The
    folded model's boxes against the unfolded model's: within HTTP_BOX_TOL
    in bf16, and in float32 reported: fold_normalize's padding taps beyond
    the canvas mean black pixels, the unfolded model's zero in normalised
    space (nn/fold.py), and that edge ring moves a float32 box by more than
    1e-4 of the side. In float32 the fold is held where it is exact
    instead: layer1's output inside its edge ring (``interior_gap``) within
    FOLD_INTERIOR_TOL."""
    import threading

    import torch

    from reftr_torch.cli.presets import preset_config
    from reftr_torch.serve import ServingModel
    from reftr_torch.tools import serve as serve_tools
    from reftr_torch.train.loop import build_tokenizer

    decode = serve_tools.decode_image
    serve_tools.decode_image = npy_decode
    out = {}
    try:
        for dtype, n in FOLD_REQUESTS.items():
            reqs = served["reqs"][:n]
            cfg = preset_config("refcoco_det", dtype=dtype,
                                dataset="synthetic", resume=pth["url"],
                                **FOLDS)
            t0 = time.perf_counter()
            server, batcher = serve_tools.build_server(
                cfg, "127.0.0.1", 0, HTTP_BATCH, HTTP_TIMEOUT_MS)
            th = threading.Thread(target=server.serve_forever, daemon=True)
            th.start()
            base = f"http://127.0.0.1:{server.server_address[1]}"
            fe = serve_tools.Frontend(cfg, build_tokenizer(cfg))
            try:
                code, warm, _ = http_call(base + "/predict", {
                    "image_b64": npy_b64(reqs[0][0]),
                    "phrases": reqs[0][1]})
                if code != 200:
                    raise AssertionError(f"fold http: warm-up {code} {warm}")
                torch.cuda.synchronize()
                build_s = time.perf_counter() - t0
                run = http_load(base, reqs, FOLD_CLIENTS, counters, batcher)
            finally:
                server.shutdown()
                batcher.stop()
                server.server_close()
                th.join(timeout=10)
            folded = batcher.model
            del server, batcher
            if not (folded.model.img_backbone.bn1.folded
                    and folded.model.config.fold_normalize):
                raise AssertionError("fold http: the server's model is not "
                                     "folded")
            want_n = expected_launches(run["batches"], dtype, False)
            if run["launches"] != want_n:
                raise AssertionError(f"fold http {dtype}: launches "
                                     f"{run['launches']} for "
                                     f"{run['batches']} batches, not "
                                     f"{want_n}")
            tol = HTTP_BOX_TOL[dtype]
            boxes = {"folded": direct_boxes(folded, fe, reqs)}
            run["box_err"] = check_answers(f"fold http {dtype}", reqs,
                                           run.pop("answers"),
                                           boxes["folded"], tol)
            models = {"folded": folded}
            for label, flags in (("unfolded", {}),
                                 ("fold_bn", {"fold_bn": True})):
                c = preset_config("refcoco_det", dtype=dtype,
                                  dataset="synthetic", **flags)
                models[label] = ServingModel(c, HTTP_BATCH,
                                             resume=pth["path"])
                boxes[label] = direct_boxes(models[label], fe, reqs)
            run["fold_bn_from_unfolded"] = box_gap(reqs, boxes["fold_bn"],
                                                   boxes["unfolded"])
            run["folded_from_unfolded"] = box_gap(reqs, boxes["folded"],
                                                  boxes["unfolded"])
            run["folded_from_fold_bn"] = box_gap(reqs, boxes["folded"],
                                                 boxes["fold_bn"])
            held = ["fold_bn_from_unfolded"]
            if dtype == "float32":
                run["layer1_interior_gap"] = interior_gap(
                    folded, models["unfolded"],
                    export_batches(served["reqs"], cfg, 1)[0])
            else:
                held.append("folded_from_unfolded")
            del models, folded
            torch.cuda.empty_cache()
            run["build_and_warm_s"] = build_s
            print(f"fold http {dtype} ({report['card']}): --fold_bn "
                  f"--fold_normalize server built, .pth loaded by URL and "
                  f"folded, warmed in {build_s:.1f} s; "
                  f"{run['sent_requests']} requests from {FOLD_CLIENTS} "
                  f"clients, {run['batches']} batches: "
                  f"{run['requests_per_s']:.2f} requests/s, p50 "
                  f"{run['p50_ms']:.2f} ms; largest box error against its "
                  f"own model's direct forward {run['box_err']:.3g} of the "
                  f"side (tol {tol}); direct forwards: fold_bn alone from "
                  f"the unfolded model {run['fold_bn_from_unfolded']:.3g}, "
                  f"fold_bn + fold_normalize from the unfolded "
                  f"{run['folded_from_unfolded']:.3g} and from fold_bn "
                  f"alone {run['folded_from_fold_bn']:.3g} (held at {tol}: "
                  f"{held}); layer1 inside its edge ring, folded from "
                  f"unfolded, float32: "
                  f"{run.get('layer1_interior_gap', 'not run (bf16)')} "
                  f"(tol {FOLD_INTERIOR_TOL}); launches {run['launches']}",
                  flush=True)
            for what in held:
                if not run[what] <= tol:
                    raise AssertionError(f"fold http {dtype}: {what} "
                                         f"{run[what]:.3g} of the side "
                                         f"(tol {tol})")
            if not run.get("layer1_interior_gap", 0.0) <= FOLD_INTERIOR_TOL:
                raise AssertionError(f"fold http {dtype}: layer1 interior "
                                     f"{run['layer1_interior_gap']:.3g} "
                                     f"(tol {FOLD_INTERIOR_TOL})")
            out[dtype] = run
    finally:
        serve_tools.decode_image = decode
    report["fold_http"] = out
    return out


def fold_profile(report: dict) -> dict:
    """Phase 13c, report only: ``op_profile rec`` (the bf16 serving forward
    at batch 64) unfolded and folded (fold_bn, fold_normalize), in turns:
    device ms a forward, the elementwise kernels' ms and share. Both must
    name K1's kernels."""
    import torch

    from reftr_torch.tools import op_profile

    out = {"unfolded": [], "folded": []}
    for _ in range(STEP_TURNS):
        for label in out:
            rows = op_profile.profile("rec", topk=8, steps=3,
                                      unfolded=label == "unfolded")
            cats = {r["category"] for r in rows}
            if not {"flash_attn_fwd_tc", "flash_attn_fwd_dec"} <= cats:
                raise AssertionError(f"op_profile rec {label}: no K1 "
                                     f"kernel among {sorted(cats)}")
            total = sum(r["ms"] for r in rows)
            elem = sum(r["ms"] for r in rows
                       if r["category"] == "elementwise")
            out[label].append({
                "device_ms": total, "elementwise_ms": elem,
                "elementwise_share": elem / total, "kernels": len(rows),
                "top": [{k: r[k] for k in ("name", "category", "ms",
                                           "calls")} for r in rows[:6]]})
            torch.cuda.empty_cache()
    for label, runs in out.items():
        print(f"fold profile ({report['card']}): op_profile rec {label}: "
              f"device {ms_list(r['device_ms'] for r in runs)} ms a forward "
              f"at batch 64; elementwise "
              f"{ms_list(r['elementwise_ms'] for r in runs)} ms, share "
              f"{', '.join(f'{r['elementwise_share']:.3f}' for r in runs)}",
              flush=True)
    report["fold_profile"] = out
    return out


def step_turns(report: dict, counters, variants: dict, batch, targets,
               what: str, sites=REC_SITES, extra=None) -> dict:
    """Report only, but for the launches: bf16 train steps of each of
    ``variants`` (label -> (TrainState, its step, a function that sets the
    model up for the label or None)), in turns STEP_TURNS times after
    STEP_WARM steps each: host ms, peak device memory of one step above
    the memory held before it, device ms by torch.profiler (STEP_ITERS
    steps), and the launches of that one counted step, which must be the
    rule's for ``sites`` plus ``extra(label)``."""
    import torch

    from reftr_torch.tools.op_profile import profile_device

    holders = {label: {"state": state, "step": step, "setup": setup}
               for label, (state, step, setup) in variants.items()}

    def run(h) -> None:
        if h["setup"] is not None:
            h["setup"](h["state"].model)
        h["state"], metrics = h["step"](h["state"], batch, targets)
        metrics.get()

    for h in holders.values():
        for _ in range(STEP_WARM):
            run(h)
    readings = {label: [] for label in holders}
    for turn in range(STEP_TURNS):
        for label, h in holders.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts(counters)
            t0 = time.perf_counter()
            run(h)
            host_ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts(counters)
            peak = torch.cuda.max_memory_allocated()
            want = expected_launches(1, "bfloat16", True, sites)
            for k, v in (extra(label) if extra else {}).items():
                want[k] += v
            if launches != want:
                raise AssertionError(f"{what} {label}: launches {launches}, "
                                     f"not {want}")
            prof = profile_device(lambda h=h: run(h),
                                  f"{what} {label} (turn {turn})", host_ms,
                                  iters=STEP_ITERS)
            readings[label].append({
                "host_ms": host_ms, "device_ms": prof["device_ms"],
                "peak_gb": peak / 1e9, "step_peak_gb": (peak - held) / 1e9,
                "held_gb": held / 1e9, "launches": launches,
                "by_category_ms": prof.get("by_category_ms")})
    for label, runs in readings.items():
        print(f"{what} {label} ({report['card']}): device "
              f"{', '.join(fmt_ms(r['device_ms']) for r in runs)} ms a step "
              f"(turns); host {ms_list(r['host_ms'] for r in runs)} ms; "
              f"peak {', '.join(f'{r['peak_gb']:.2f}' for r in runs)} GB "
              f"({', '.join(f'{r['step_peak_gb']:.2f}' for r in runs)} GB "
              f"above the {runs[0]['held_gb']:.2f} GB held); launches "
              f"{runs[0]['launches']}", flush=True)
    return readings


def bf16_state(cfg, **flags) -> tuple:
    """(TrainState, its train step) of ``cfg``'s model with ``flags``, in
    bf16, from seed 0, on the card."""
    from reftr_torch.train.state import TrainState
    from reftr_torch.train.steps import make_train_step

    mc = dataclasses.replace(cfg.model, dtype="bfloat16", **flags)
    state = TrainState.create(mc, cfg.train, 10, seed=0)
    return state, make_train_step(state.model, model_weights(cfg.loss, mc),
                                  cfg.loss)


def s2d_step(report: dict, counters) -> dict:
    """Phase 13d: REC's bf16 batch-8 train step with the standard stem and
    FrozenBN against --space_to_depth_stem --fold_bn (each model's seeded
    init, folded for the second), in turns (``step_turns``)."""
    import torch

    from reftr_torch.cli.presets import preset_config

    cfg = preset_config("refcoco_det")
    batch, targets = train_batch(np.random.default_rng(13), cfg.data.img_size,
                                 cfg.data.max_query_len,
                                 cfg.model.bert.vocab_size, SERVE_BATCH)
    variants = {"standard": (*bf16_state(cfg), None),
                "s2d_fold_bn": (*bf16_state(cfg, **S2D), None)}
    report["s2d_step"] = step_turns(
        report, counters, variants, batch, targets,
        f"s2d: bf16 batch {SERVE_BATCH} REC step")
    del variants
    torch.cuda.empty_cache()
    return report["s2d_step"]


def set_remat(on: bool):
    """A model setup for ``step_turns``: the VL encoder's layers and every
    bottleneck recomputed in the backward (--remat --backbone_remat) or
    kept."""
    def setup(model) -> None:
        model.vl_transformer.encoder.remat = on
        model.img_backbone.remat_stages = frozenset(range(1, 5) if on
                                                    else ())
    return setup


def remat_grads(model, batch, targets, loss_cfg, wd) -> tuple:
    """One bf16-autocast forward and backward of ``model`` in training
    mode at the preset's dropout, from fixed seeds: (loss, the trainable
    gradients)."""
    import torch

    from reftr_torch.models.criterion import criterion, total_loss
    from reftr_torch.nn.attention import attention_rng
    from reftr_torch.train.steps import to_device

    model.train()
    model.zero_grad(set_to_none=True)
    dev = torch.device("cuda")
    b, tg = to_device(batch, dev), to_device(targets, dev)
    gen = torch.Generator()
    gen.manual_seed(17)
    with torch.random.fork_rng(devices=[dev.index or 0]):
        torch.manual_seed(17)
        with torch.autocast("cuda", dtype=torch.bfloat16), attention_rng(gen):
            out = model(b)
        loss = total_loss(criterion(out, tg, loss_cfg), wd)
        loss.backward()
    return loss.item(), {n: p.grad.float().clone()
                         for n, p in model.named_parameters()
                         if p.grad is not None}


def remat_step(report: dict, counters) -> dict:
    """Phase 13e: refcoco_det's bf16 step at four feature levels (the
    encoder over 8540 tokens), batch 8, with --remat --backbone_remat and
    without, on one model. First one forward and backward each way at
    dropout 0.1 from the same seeds: the recompute must draw the
    forward's masks, so the loss within TRAIN_LOSS_TOL and every
    gradient within TRAIN_GRAD_TOL rel L2 (phase 5's rule); then the
    steps in turns (``step_turns``): peak memory and device ms, and the
    launches: the rule's 30 of each kernel, and with remat K1 again in
    each of the encoder's 6 recomputed layers."""
    import torch

    from reftr_torch.cli.presets import preset_config

    cfg = preset_config("refcoco_det", num_feature_levels=4, **REMAT)
    batch, targets = train_batch(np.random.default_rng(18), cfg.data.img_size,
                                 cfg.data.max_query_len,
                                 cfg.model.bert.vocab_size, SERVE_BATCH)
    state, step = bf16_state(cfg)
    model = state.model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    with torch.no_grad():  # gradients reach the attentions
        torch.nn.init.xavier_uniform_(model.bbox_embed.layers[-1].weight,
                                      generator=gen)
    wd = model_weights(cfg.loss, model.config)
    runs = {}
    for on in (False, True):
        set_remat(on)(model)
        runs[on] = remat_grads(model, batch, targets, cfg.loss, wd)
    (loss_p, g_p), (loss_r, g_r) = runs[False], runs[True]
    norm = math.sqrt(sum(float(g.square().sum()) for g in g_p.values()))
    worst, worst_name = grad_gap(g_r, g_p, norm)
    loss_err = abs(loss_r - loss_p) / abs(loss_p)
    check = {"loss_plain": loss_p, "loss_remat": loss_r,
             "loss_rel_err": loss_err, "worst_grad_rel_l2": worst,
             "worst_grad_name": worst_name, "n_trainable": len(g_p),
             "grad_norm": norm}
    print(f"remat ({report['card']}): four-level bf16 step at dropout "
          f"{DROPOUT}, recomputed against kept: loss {loss_r:.6f} vs "
          f"{loss_p:.6f} (rel {loss_err:.3g}, tol {TRAIN_LOSS_TOL}); worst "
          f"gradient rel L2 {worst:.3g} at {worst_name} (tol "
          f"{TRAIN_GRAD_TOL}) over {len(g_p)} tensors", flush=True)
    if not (loss_err <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
        raise AssertionError(f"remat: loss rel {loss_err:.3g}, gradient "
                             f"rel L2 {worst:.3g} at {worst_name}")
    del runs, g_p, g_r
    encoder = ((6, LONG_S, LONG_S, 32),)

    def extra(label):
        if label == "kept":
            return {}
        return expected_launches(1, "bfloat16", False, encoder)

    readings = step_turns(
        report, counters, {"kept": (state, step, set_remat(False)),
                           "remat": (state, step, set_remat(True))},
        batch, targets,
        f"remat: bf16 batch {SERVE_BATCH} step at 4 feature levels",
        sites=LEVELS_SITES, extra=extra)
    del state, step, model
    torch.cuda.empty_cache()
    report["remat_step"] = {"grads": check, "turns": readings}
    return report["remat_step"]


def phase13(report: dict, counters, pth: dict, served: dict,
            tmp: Path) -> dict:
    """Phase 13: the folded server (13a) and its export (13b), the folded
    forward's profile (13c), the s2d stem's step (13d) and remat's (13e),
    in phase 11's temporary directory."""
    t0 = time.perf_counter()
    parts = {}
    for part, run in (
            ("a", lambda: fold_http(report, counters, pth, served)),
            ("b", lambda: export_model_phase(
                report, counters, pth, tmp, served["reqs"], flags=FOLDS,
                dtypes=("bfloat16",), key="fold_export")),
            ("c", lambda: fold_profile(report)),
            ("d", lambda: s2d_step(report, counters)),
            ("e", lambda: remat_step(report, counters))):
        t = time.perf_counter()
        run()
        parts[part] = time.perf_counter() - t
    report["phase13_s"] = time.perf_counter() - t0
    print(f"folds: phase 13 in {report['phase13_s']:.1f} s ("
          + ", ".join(f"13{k} {v:.1f} s" for k, v in parts.items()) + ")",
          flush=True)
    return report


def fold_launches(report: dict) -> dict:
    """The launches of phase 13's counted runs (13a's loads, 13b's
    batches, 13d's and 13e's counted steps), summed."""
    runs = [r["launches"] for r in report["fold_http"].values()]
    runs += [r["launches"] for r in report["fold_export"].values()]
    runs += [t["launches"] for key in ("s2d_step",)
             for v in report[key].values() for t in v]
    runs += [t["launches"] for v in report["remat_step"]["turns"].values()
             for t in v]
    return {k: sum(n[k] for n in runs) for k in runs[0]}


def http_launches(report: dict) -> dict:
    """The launches of phase 11's loads (11b) and predict calls (11c),
    summed."""
    runs = [run["launches"] for res in report["http"].values()
            for run in res["loads"].values()]
    runs += [r["launches"] for r in report["predict"]]
    return {k: sum(n[k] for n in runs) for k in runs[0]}


def export_launches(report: dict) -> dict:
    """The launches of phase 12's runs of the exported program (12b's
    counted batches in both dtypes, 12c's HTTP load), summed."""
    runs = [res["launches"] for res in report["export"].values()]
    runs.append(report["export_http"]["launches"])
    return {k: sum(n[k] for n in runs) for k in runs[0]}


CHILDREN = {"child-cli": child_cli, "child-pair": child_pair,
            "child-times": child_times}


def kernel_line(report: dict) -> list:
    """Every variant of each kernel at the call site and dtype where the
    main path launches it (MAIN_SITE, MAIN_DTYPE; bfloat16 but for the
    3xTF32 kernels): K1 as served (no dropout; its times with the training
    dropout beside them), K2 and K3 as trained (dropout 0.1; without it
    beside). ``ms`` is the host loop's time per call (CUDA events around
    back-to-back wrapper calls), ``device_ms`` the card's time per call
    (torch.profiler); a K3 row of another variant than SIMT has the SIMT
    kernel's device time at its site beside it (the same-run "before"),
    and a K1 or K2 row so where the SIMT K1 and K2 are timed
    (``simt_timed``). ``launches`` counts the main path's runs: both
    serving runs
    (bf16 and float32), both training runs (the bf16 steps and the
    float32 steps), the trainer's entry point (phase 6's three runs), RES
    (phase 7's fine-tune, eval-only pass, freeze_reftr steps and
    serving) and phase 8's runs of the entry point (multi-phrase and its
    eval-only pass, four feature levels, RoBERTa), phase 9a's DDP run
    of the entry point and phase 10's runs (the from-scratch recipe through
    the entry point, its eval-only pass and its serving) and phase 11's
    (the HTTP server's loads and predict) and phase 12's (the exported
    program's batches and its HTTP load) and phase 13's (the folded
    server's loads and its export's batches, the counted s2d and remat
    steps), split in
    ``launches_serve``, ``launches_train``, ``launches_cli``,
    ``launches_res``, ``launches_multi``, ``launches_ddp``,
    ``launches_scratch``, ``launches_http``, ``launches_export`` and
    ``launches_fold``.
    The decode backward has one row for K2 and K3, whose launches it is
    counted in. Every site's numbers are in the JSON report written before
    it."""
    sites = report["call_sites"]
    rows = report["train_kernels"]
    train_n = {k: report["train"]["launches"][k]
               + report["train_f32"]["launches"][k]
               for k in report["train"]["launches"]}
    serve_n = {k: report["serve"]["launches"][k]
               + report["serve"]["f32_launches"][k]
               for k in report["serve"]["launches"]}
    cli_n = {k: sum(n[k] for n in report["cli"]["launches"].values())
             for k in train_n}
    res = report["res"]
    res_runs = [*res["launches"].values(), res["freeze"]["launches"],
                *(v["launches"] for v in res["serve"].values())]
    res_n = {k: sum(n[k] for n in res_runs) for k in train_n}
    multi_n = phase8_launches(report)
    ddp_n = report["ddp_cli"]["launches"]
    shorts = {"flash_attn_fwd": "fwd", "flash_attn_bwd_dq": "dq",
              "flash_attn_bwd_dkv": "dkv"}
    grads_of = {"fwd": ("fwd",), "dq": ("dq",), "dkv": ("dk", "dv")}
    out = []
    for name, (source, replaces, variant) in KERNELS.items():
        if name == "flash_attn_bwd_dec":
            out.append(bwd_dec_entry(report, name, source, replaces,
                                     train_n, serve_n, cli_n, res_n,
                                     multi_n))
            continue
        if variant == "wg":
            out.append(wg_entry(report, name, source, replaces, train_n,
                                serve_n, cli_n, res_n, multi_n))
            continue
        base = name
        for suffix in ("_f32tc", "_tc", "_wg", "_dec"):
            base = base.removesuffix(suffix)
        short = shorts[base]
        site = MAIN_SITE[variant]
        dtype = MAIN_DTYPE.get(variant, "bfloat16")

        def count(n):
            return row_launches({"name": name, "variant": variant}, n)

        # the errors of every call of this variant: as the rule picked it,
        # or as the same-run "before" beside another variant
        errs = []
        for r in rows + report["scratch_kernels"] + report["http_kernels"]:
            scale = 1.0 if short == "fwd" else r["grad_scale"]
            if r[f"{short}_variant"] == variant:
                errs += [(r[f"{g}_max_abs_err"], scale)
                         for g in grads_of[short]]
            elif f"{variant}_{short}_max_abs_err" in r:
                errs.append((r[f"{variant}_{short}_max_abs_err"], scale))
        if short == "fwd":
            errs += [(r["max_abs_err"], 1.0) for r in sites
                     if r["variant"] == variant]
            if variant == "simt":
                errs += [(r["simt_max_abs_err"], 1.0) for r in sites
                         if "simt_max_abs_err" in r]
        tr, tr0 = (next(r for r in rows if r["site"] == site
                        and r["dtype"] == dtype and r["dropout"] == rate)
                   for rate in (DROPOUT, 0.0))
        key = (short if tr[f"{short}_variant"] == variant
               else f"{variant}_{short}")
        shape = (f"{site} {dtype} B={tr['B']} Sq={tr['Sq']} Sk={tr['Sk']} "
                 f"H={tr['H']} D={tr['D']}")
        entry = {"name": name, "route": "cuda", "variant": variant,
                 "source": f"reftr_torch/kernels/csrc/{source}",
                 "replaces": replaces,
                 "launches": (count(train_n) + count(serve_n)
                              + count(cli_n) + count(res_n)
                              + count(multi_n) + count(ddp_n)),
                 "launches_train": count(train_n),
                 "launches_train_f32": count(report["train_f32"]["launches"]),
                 "launches_serve": count(serve_n),
                 "launches_cli": count(cli_n),
                 "launches_res": count(res_n),
                 "launches_multi": count(multi_n),
                 "launches_ddp": count(ddp_n),
                 "max_abs_err": max(e for e, _ in errs), "site": site}
        if short == "fwd":
            sv = next(r for r in sites
                      if r["site"] == site and r["dtype"] == dtype)
            pre = "" if sv["variant"] == variant else "simt_"
            entry.update({
                "shape": f"{shape}, no dropout",
                "ms": sv[f"{pre}ms"], "device_ms": sv[f"{pre}device_ms"],
                "ms_dropout": tr[f"{key}_ms"],
                "device_ms_dropout": tr[f"{key}_device_ms"],
                "plain_ms": sv["plain_ms"], "bound_ms": sv["bound_ms"],
                "bound_by": sv["bound_by"],
                "library_ms": sv["library_ms"],
                "library_device_ms": sv["library_device_ms"],
                "library_device_ms_dropout": tr["sdpa_fwd_device_ms"]})
            if variant != "simt" and simt_timed(site, dtype):
                entry.update({
                    "simt_device_ms": sv["simt_device_ms"],
                    "simt_device_ms_dropout": tr["simt_fwd_device_ms"]})
        else:
            entry.update({
                "max_rel_err": max(e / s for e, s in errs),
                "shape": f"{shape}, dropout {DROPOUT}",
                "ms": tr[f"{key}_ms"], "device_ms": tr[f"{key}_device_ms"],
                "plain_ms": tr["bwd_plain_ms"],
                "plain_covers": "attention_bwd_plain: dq, dk and dv",
                "bound_ms": tr[f"{base}_bound_ms"],
                "bound_by": tr[f"{base}_bound_by"],
                "library_ms": tr["sdpa_bwd_ms"],
                "library_device_ms": tr["sdpa_bwd_device_ms"],
                "library_covers": "SDPA backward (host loop: fwd+bwd minus "
                                  "fwd; device: the backward's kernels): "
                                  "K2 and K3 together",
                "device_ms_no_dropout": tr0[f"{key}_device_ms"],
                "library_device_ms_no_dropout": tr0["sdpa_bwd_device_ms"]})
            if variant != "simt" and (short == "dkv"
                                      or simt_timed(site, dtype)):
                entry.update({
                    "simt_device_ms": tr[f"simt_{short}_device_ms"],
                    "simt_device_ms_no_dropout":
                        tr0[f"simt_{short}_device_ms"]})
            elif short == "dkv":
                # where the rule sends K3 to SIMT (phase 3c)
                entry["rule_site"] = [
                    {key: r[key] for key in (
                        "dtype", "dropout", "B", "Sq", "Sk", "H", "D",
                        "device_ms", "bound_ms", "bound_by", "plain_ms",
                        "sdpa_bwd_device_ms", "max_abs_err")}
                    for r in report["simt_dkv"]]
        out.append(entry)
    # phase 10's runs of the entry point and its serving and phase 11's,
    # and the largest error of each variant at the recipe's sites and at
    # the server's batch (its max_abs_err includes them)
    scratch_n = scratch_launches(report)
    http_n = http_launches(report)
    export_n = export_launches(report)
    fold_n = fold_launches(report)
    for entry in out:
        entry["launches_scratch"] = row_launches(entry, scratch_n)
        entry["launches_http"] = row_launches(entry, http_n)
        entry["launches_export"] = row_launches(entry, export_n)
        entry["launches_fold"] = row_launches(entry, fold_n)
        entry["launches"] += (entry["launches_scratch"]
                              + entry["launches_http"]
                              + entry["launches_export"]
                              + entry["launches_fold"])
        entry.update(phase_err(report, entry, "scratch"))
        entry.update(phase_err(report, entry, "http"))
    return out


def phase_err(report: dict, entry: dict, phase: str) -> dict:
    """The largest errors of a kernels line row's variant over the checks
    report[f"{phase}_kernels"] at a phase's own sites (K1's out and lse,
    K2's dq, K3's dk and dv, the decode backward's dq, dk and dv), as the
    rule sent calls to it or as the same-run "before"; None where it did
    not run there."""
    base = entry["name"]
    for suffix in ("_f32tc", "_tc", "_wg", "_dec"):
        base = base.removesuffix(suffix)
    short = {"flash_attn_fwd": "fwd", "flash_attn_bwd_dq": "dq",
             "flash_attn_bwd_dkv": "dkv", "flash_attn_bwd": "dq"}[base]
    parts = {"fwd": ("fwd", "lse"), "dq": ("dq",), "dkv": ("dk", "dv")}
    if base == "flash_attn_bwd":  # the decode backward: one launch, three
        parts["dq"] = ("dq", "dk", "dv")
    errs = {}
    for r in report[f"{phase}_kernels"]:
        if r[f"{short}_variant"] == entry["variant"]:
            for g in parts[short]:
                errs.setdefault(g, []).append(r[f"{g}_max_abs_err"])
        elif f"{entry['variant']}_{short}_max_abs_err" in r:
            errs.setdefault(short, []).append(
                r[f"{entry['variant']}_{short}_max_abs_err"])
    out = {f"{phase}_max_abs_err": max(
        (e for g, v in errs.items() if g != "lse" for e in v), default=None)}
    if short == "fwd":
        out[f"{phase}_lse_max_abs_err"] = max(errs.get("lse", ()),
                                              default=None)
    return out


def scratch_launches(report: dict) -> dict:
    """The launches of phase 10's runs (10a's two, 10d's serving),
    summed."""
    runs = [*report["scratch"]["launches"].values(),
            report["scratch_serve"]["launches"]]
    return {k: sum(n[k] for n in runs) for k in runs[0]}


def row_launches(entry: dict, n: dict) -> int:
    """A kernels line row's launches among the counters ``n``: its
    variant's count on its wrapper (the decode backward's on K2's), the
    SIMT kernel's what no other variant took."""
    if entry["name"] == "flash_attn_bwd_dec":
        return n["flash_attn_bwd_dq_dec"]
    base = entry["name"]
    for suffix in ("_f32tc", "_tc", "_wg", "_dec"):
        base = base.removesuffix(suffix)
    wrapper = "flash_attention" if base == "flash_attn_fwd" else base
    if entry["variant"] != "simt":
        return n[f"{wrapper}_{entry['variant']}"]
    return n[wrapper] - sum(n.get(f"{wrapper}_{v}", 0)
                            for v in ("tc", "wg", "tf32x3", "dec"))


def wg_entry(report: dict, name: str, source: str, replaces: str,
             train_n: dict, serve_n: dict, cli_n: dict, res_n: dict,
             multi_n: dict) -> dict:
    """The kernels line's row of a warpgroup kernel (K1-wg, K2-wg or
    K3-wg): its launches on the main paths, its errors over every check
    that ran it (phases 3, 8b and 8d through the rule, 3d's), and its times
    at the four-level encoder at B=8 from phase 3d: K1 as served (no
    dropout, with 0.1 beside), K2 and K3 as trained (dropout 0.1, without
    beside), each beside the mma.sync kernel and SDPA of the same turns.
    The plain version runs at B=1 (phase 8d): its scores at B=8 would hold
    18.7 GB."""
    short = next(x for x in ("fwd", "dq", "dkv") if f"_{x}_" in name)
    wrapper = {"fwd": "flash_attention", "dq": "flash_attn_bwd_dq",
               "dkv": "flash_attn_bwd_dkv"}[short]
    kernel = {"fwd": "flash_attn_fwd", "dq": "flash_attn_bwd_dq",
              "dkv": "flash_attn_bwd_dkv"}[short]
    grads = {"fwd": ("fwd",), "dq": ("dq",), "dkv": ("dk", "dv")}[short]
    scale_key = {"fwd": None, "dq": "grad_scale_dq",
                 "dkv": "grad_scale"}[short]
    rows = [r for key in ("train_kernels", "multi_kernels", "levels_kernels",
                          "scratch_kernels", "http_kernels")
            for r in report.get(key, ())]
    errs = [(r[f"{g}_max_abs_err"], 1.0 if short == "fwd" else
             r["grad_scale"]) for r in rows if r[f"{short}_variant"] == "wg"
            for g in grads]
    errs += [(t["max_abs_err"][g], 1.0 if short == "fwd" else
              t[scale_key]) for t in report["wg_times"] for g in grads]
    rate = 0.0 if short == "fwd" else DROPOUT
    t, t_other = (next(r for r in report["wg_times"]
                       if r["site"] == MAIN_SITE["wg"] and r["dropout"] == x)
                  for x in (rate, DROPOUT - rate))
    plain = next(r for r in report["levels_kernels"]
                 if r["dtype"] == "bfloat16" and r["dropout"] == rate)
    mine, tc, lib = {"fwd": ("k1_wg", "k1_tc", "sdpa_fwd"),
                     "dq": ("k2_wg", "k2_tc", "sdpa_bwd"),
                     "dkv": ("k3_wg", "k3_tc", "sdpa_bwd")}[short]
    bound = t["bounds"][kernel]
    top = max(bound, key=bound.get)

    def count(n):
        return n[f"{wrapper}_wg"]

    ddp_n = report["ddp_cli"]["launches"]
    return {
        "name": name, "route": "cuda", "variant": "wg",
        "source": f"reftr_torch/kernels/csrc/{source}", "replaces": replaces,
        "launches": (count(train_n) + count(serve_n) + count(cli_n)
                     + count(res_n) + count(multi_n) + count(ddp_n)),
        "launches_train": count(train_n),
        "launches_train_f32": count(report["train_f32"]["launches"]),
        "launches_serve": count(serve_n), "launches_cli": count(cli_n),
        "launches_res": count(res_n), "launches_multi": count(multi_n),
        "launches_ddp": count(ddp_n),
        "max_abs_err": max(e for e, _ in errs),
        "max_rel_err": max(e / s for e, s in errs),
        "site": MAIN_SITE["wg"],
        "shape": (f"{t['site']} bfloat16 B={t['B']} Sq={t['Sq']} "
                  f"Sk={t['Sk']} H={t['H']} D={t['D']}, dropout {rate}"),
        "ms": t["ms"][mine], f"ms_dropout_{DROPOUT - rate}":
            t_other["ms"][mine],
        "tc_ms": t["ms"][tc], "library_ms": t["ms"][lib],
        "library_covers": ("SDPA forward" if short == "fwd" else
                           "SDPA backward: K2 and K3 together"),
        "k2_tc_ms": t["ms"]["k2_tc"], "k2_wg_ms": t["ms"]["k2_wg"],
        "k3_wg_ms": t["ms"]["k3_wg"],
        "plain_ms": (plain["fwd_plain_ms"] if short == "fwd"
                     else plain["bwd_plain_ms"]),
        "plain_shape": "vl_encoder_4_levels B=1 (phase 8d)",
        "bound_ms": bound[top],
        "bound_by": "bytes" if top == "bytes" else "operations",
        "bound_terms_ms": bound}


def phase8_launches(report: dict) -> dict:
    """The launches of phase 8's runs of the entry point, summed."""
    runs = [*report["multi"]["launches"].values(),
            report["levels"]["launches"]["train"],
            report["roberta"]["launches"]["train"]]
    return {k: sum(n[k] for n in runs) for k in runs[0]}


def bwd_dec_entry(report: dict, name: str, source: str, replaces: str,
                  train_n: dict, serve_n: dict, cli_n: dict,
                  res_n: dict, multi_n: dict) -> dict:
    """The kernels line's row of the decode backward, which replaces K2 and
    K3 below 16 queries: its launches (each counted on K2 and on K3, so
    K2's count), its errors over every call of phase 3 that the rule sent
    to it, and its times at the decoder's cross-attention in bf16 with
    dropout 0.1 (and without), beside the SIMT K2 + K3 pair of the same
    run and SDPA's whole backward."""
    rows = report["train_kernels"]
    errs = [(r[f"{g}_max_abs_err"], r["grad_scale"])
            for r in rows + report["http_kernels"]
            if r["dq_variant"] == "dec" for g in ("dq", "dk", "dv")]
    tr, tr0 = (next(r for r in rows if r["site"] == "decoder_cross"
                    and r["dtype"] == "bfloat16" and r["dropout"] == rate)
               for rate in (DROPOUT, 0.0))
    key = "flash_attn_bwd_dq_dec"
    ddp_n = report["ddp_cli"]["launches"]
    return {
        "name": name, "route": "cuda", "variant": "dec",
        "source": f"reftr_torch/kernels/csrc/{source}",
        "replaces": replaces, "also_replaces": BWD_DEC_ALSO,
        "launches": (train_n[key] + serve_n[key] + cli_n[key] + res_n[key]
                     + multi_n[key] + ddp_n[key]),
        "launches_train": train_n[key],
        "launches_train_f32": report["train_f32"]["launches"][key],
        "launches_serve": serve_n[key],
        "launches_cli": cli_n[key],
        "launches_res": res_n[key],
        "launches_multi": multi_n[key],
        "launches_ddp": ddp_n[key],
        "max_abs_err": max(e for e, _ in errs),
        "max_rel_err": max(e / s for e, s in errs),
        "site": "decoder_cross",
        "shape": (f"decoder_cross bfloat16 B={tr['B']} Sq={tr['Sq']} "
                  f"Sk={tr['Sk']} H={tr['H']} D={tr['D']}, dropout "
                  f"{DROPOUT}"),
        "ms": tr["bwd_ms"], "device_ms": tr["bwd_device_ms"],
        "ms_no_dropout": tr0["bwd_ms"],
        "device_ms_no_dropout": tr0["bwd_device_ms"],
        "simt_pair_device_ms": sum_ms(tr["simt_dq_device_ms"],
                                      tr["simt_dkv_device_ms"]),
        "simt_pair_device_ms_no_dropout": sum_ms(tr0["simt_dq_device_ms"],
                                                 tr0["simt_dkv_device_ms"]),
        "plain_ms": tr["bwd_plain_ms"],
        "plain_covers": "attention_bwd_plain: dq, dk and dv",
        "bound_ms": tr["flash_attn_bwd_bound_ms"],
        "bound_by": tr["flash_attn_bwd_bound_by"],
        "library_ms": tr["sdpa_bwd_ms"],
        "library_device_ms": tr["sdpa_bwd_device_ms"],
        "library_device_ms_no_dropout": tr0["sdpa_bwd_device_ms"],
        "library_covers": "SDPA backward (host loop: fwd+bwd minus fwd; "
                          "device: the backward's kernels): dq, dk and dv",
        "bitwise_repeatable": all(r.get("bitwise_repeatable", False)
                                  for r in rows if r["dq_variant"] == "dec")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from reftr_torch.data import native
    from reftr_torch.kernels import _nvcc
    from reftr_torch.kernels.attention import (flash_attention,
                                               flash_attn_bwd_dkv,
                                               flash_attn_bwd_dq)

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    sources = sorted({src for src, _, _ in KERNELS.values()})
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        data_lib = pool.submit(native.build)
        libs = dict(zip(sources, pool.map(_nvcc.build, sources)))
        data_lib = data_lib.result()
    print(f"built {', '.join(sources)} and the data pipeline's "
          f"{data_lib.relative_to(ROOT)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    # the tensor-core kernels' machine code must hold tensor-core products:
    # mma.sync's HMMA in the bf16 and 3xTF32 ones, wgmma's HGMMA in the
    # warpgroup ones
    hmma = {src: sass_count(libs[src], "HMMA")
            for src, _, variant in KERNELS.values()
            if variant in ("tc", "tf32x3")}
    hgmma = {src: sass_count(libs[src], "HGMMA")
             for src, _, variant in KERNELS.values() if variant == "wg"}
    print(f"cuobjdump -sass: HMMA instructions {hmma}; HGMMA instructions "
          f"{hgmma}", flush=True)
    if not all(hmma.values()) or not all(hgmma.values()):
        raise AssertionError(f"a tensor-core kernel has no tensor-core "
                             f"product: HMMA {hmma}, HGMMA {hgmma}")
    sass = sass_profile(libs)
    for src, got in sass.items():
        print(f"sass {src} (D=32 function, static counts): {got['sass']}; "
              f"ptxas: {'; '.join(got['ptxas'])}", flush=True)
    card_numbers(libs)
    print(f"bound: {CARD['sms']} SMs at {CARD['sm_clock_hz'] / 1e6:.0f} MHz "
          f"(clocks.max.sm); a Philox call is "
          f"{CARD['philox_imad_per_call']} IMADs in K1-wg's machine code",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}", flush=True)

    counters = [flash_attention, flash_attn_bwd_dq, flash_attn_bwd_dkv]
    report = {"card": card, "hmma": hmma, "hgmma": hgmma,
              "bound_card": dict(CARD), "sass": sass}
    check_kernel(report)
    check_training_kernels(report)
    check_head_dims(report)
    check_simt_dkv(report)
    wg_times(report)
    check_keep_bits(report)
    serve(report, counters)
    torch.cuda.empty_cache()
    train(report, counters)
    train_f32(report, counters)
    train_cli(report, counters)
    torch.cuda.empty_cache()
    train_res(report, counters)
    torch.cuda.empty_cache()
    phase8(report, counters)
    phase9(report)
    phase10(report, counters)
    torch.cuda.empty_cache()
    phase11(report, counters)

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernel_line(report)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:  # a rank of phase 9, under the launcher
        sys.exit(CHILDREN[sys.argv[1]](*sys.argv[2:]))
    sys.exit(main())
