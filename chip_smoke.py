#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`incubator_mxnet_tpu_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero:

1. device — the card's name and power limit (nvidia-smi); TF32 off for
   matmuls and cuDNN, so every fp32 comparison below is fp32.
2. build — every CUDA source of the port, with nvcc, one process each.
3. kernel K1 (`fc_relu`) against its plain PyTorch version on the card,
   at the VGG-16 classifier shapes and AlexNet's fc6 (9216 -> 4096) for
   every serving bucket and M = 128 (the training batch) and a ragged
   MLP shape, fp32, bf16 and fp16,
   through the library's route and each route that takes the
   shape (tensor_core, cuda_core); times of the library's route, of each
   route, the plain version and one library call beside the bound, with
   L2 flushed before every timed launch, and each route's device time
   (torch.profiler, its kernels only); then train_mnist's mlp layers,
   (64, 784 -> 128) and (64, 128 -> 64), in fp32 through both routes,
   and the shapes K1 takes on phases 14 and 16's paths (PATH_K1: the
   mlp's layers at M = 1-32, wide_deep's deep1); at every shape both
   routes take, the route the library takes spends at most K1_ROUTE_GATE
   (1.10x the other's device time + 0.001 ms), and VGG-16's and
   AlexNet's fc6/fc7 keep the kTcMinRows rule; then the host time per call of
   each route at fc7, M = 32, beside the library call's.
4. serve VGG-16 at full width (3x224x224, 1000 classes, fp32, random
   weights from a seed) through `serving.ModelServer`: partition with
   TPU_PALLAS, save a checkpoint pair, load it, answer a closed-loop load
   of mixed-size requests from concurrent clients, then one request at a
   time of sizes that reach every bucket; check each answer against the
   unpartitioned graph on the card, and check that K1 ran twice per
   dispatched batch; then print the device time by kernel of one
   bucket-32 dispatch and the device's busy share (torch.profiler).
3b. kernels K2 (`flash_fwd`, whole KV) and K3 (`flash_fwd_stream`,
   split KV) through `flash_attention_partial` against their plain
   version `_partial_ref` on the card, in fp32 (3xTF32), bf16 and fp16:
   the long-context shapes (2, 8192, 8, 64) and (1, 32768, 1, 64),
   ring-shard offsets at T = 2048, the fully-masked shard (held to the
   contract m = -1e30, l = 0, o = 0), a ragged T = 1000 at D = 64, 128
   and 136, the wide heads (2, 8192, 8, 128) and (2, 8192, 8, 256) (two
   column groups of O), heads past 256 (the CUDA-core route: (2, 2048, 8,
   512) causal in every dtype through K2 and in fp32 through K3, a ragged
   (2, 1000, 8, 264)) and q, k, v sliced from one packed (B, T, 3, H, D)
   tensor; each case checks that its route's launch counter moved; times
   of the kernel, the plain version and SDPA (a yardstick only, where it
   computes the same function) beside the bound, with the achieved
   TFLOP/s and the share of the bound, and the call's device time under
   torch.profiler (at T <= 2048 the CUDA-event time is mostly the
   host's); then the wrapper's host time per call at (2, 2048, 8, 64).
5. the attention path at full width, the counts of K2 and K3 set to 0
   before it and read after it: `flash_attention` forward and backward
   at (2, 8192, 8, 64) bf16 causal (one K2 launch), output and gradients
   against fp32 T x T attention through autograd; `ring_attention(...,
   use_pallas=True)` without a process group (one more K2 launch, equal
   to `flash_attention`); the same in fp32 (one more K2 launch); the
   long-context envelope (1, 32768, 1, 64) causal forward and backward in
   fp32 (one K3 launch by default) and in bf16 under
   MXNET_FLASH_VMEM_MB=4 (one more K3 launch), checked the same way; then
   forward and forward+backward times beside SDPA's.

6. training: train_mnist's ``mlp`` (under MXNET_SUBGRAPH_BACKEND=
   TPU_PALLAS, so K1 runs fc1+relu1 and fc2+relu2) and ``lenet`` through
   the port's `Module.fit` on the card with train_mnist's defaults
   (synthetic MNIST, 3584 training and 512 validation images, batch 64,
   SGD lr 0.05 momentum 0.9, Xavier, 5 epochs); first the first 8 steps
   of each on the card against the same 8 steps on the CPU (same initial
   parameters and batch order; lenet's max-pool windows that flip between
   the devices are counted, see `parity_case`); K1's launches exactly 2
   per mlp train and eval forward and 0 for lenet; validation accuracy
   above 0.95; the median step ms and samples/s, and K1's share of one
   profiled mlp step's device time; then the trained mlp's checkpoint
   served through `serving.ModelServer` in fp32 (held to
   `Module.predict`) and bf16.
7. ResNet-50 v1, the BASELINE lane (bench.py:165-211): gluon
   `resnet50_v1(classes=1000)` composed on a Symbol + SoftmaxOutput,
   trained by `Module.fit` through the fused train step (BatchNorm, the
   multi-tensor SGD, the metric on the card); no TPU kernel is on this
   path (its one FC has no ReLU).  a. 3 fused steps at batch 4, 3x224x224,
   on the card against the CPU from the same Xavier parameters and
   batches, in float64: every step's loss, and from the CPU's state each
   step's parameters, momenta and 106 aux arrays (max-pool windows that
   flip between the devices are counted and excuse only conv1 and its
   BatchNorm at that step); in float32, where rounding grows through
   the 53 BatchNorms at batch 4, each device's step from the float64
   state is held to the float64 step: the card as close as the CPU.
   b. the lane at batch 128 in bf16 with multi_precision on one
   resident random batch, 8 warm + 24 timed steps:
   the fused step every step, the loss falling, images/s, step ms, peak
   memory and `mfu` (989 TFLOP/s); then fp32 at batch 32 for 16 steps
   (`mfu` of the 67 TFLOP/s CUDA-core peak, TF32 off).  c. one warm bf16
   step under torch.profiler: busy share, device ms by kernel class,
   host ms.  d. 4 fp32 steps at batch 8, the checkpoint served by
   `serving.ModelServer` for requests of 1-8 images, held to
   `Module.predict`.
8. gluon's imperative training.  a. BASELINE #3's plain loop (record,
   backward, Trainer.step) on hybridized resnet50_v2 at batch 4 in
   float64, card against CPU from the same parameters and momenta
   (7a's gates), then one card step hybridized against not.  b. at
   batch 128 in bf16 on one resident batch: bench.py's gluon lane
   (resnet50_v1 through Estimator.fit, the fused gluon step every
   batch), the same lane with the fused step off (the eager loop),
   BASELINE #3 hybridized, and the same loop un-hybridized: images/s,
   step ms, `mfu`, peak memory, `gluon_vs_module`.  c. one warm
   profiled step of each lane but the eager Estimator's.
9. the transformer LM served at GPT-2 small's widths (12 layers, 12
   heads, 768, vocab 50257, max_len 1024; random weights, GPT-2's
   initialisation), the counts of K1, K2 and K3 set to 0 before it and
   required 0 after it.  a. the decode plane on the card against the
   CPU: prefills of 5, 50 and 200 tokens and 8 teacher-forced ticks
   (logits, caches, argmax at clear margins), a step against the prefill
   of what it had seen, a prefill against the hybridized gluon forward,
   bf16 against fp32.  b. `serving.DecodeEngine` (8 slots, buckets 8, 64,
   256) on a mixed trace from 8 client threads in fp32 and bf16, every
   continuation equal to a lockstep lane's; tokens/s, ticks, prefill
   ms.  c. one warm tick under torch.profiler.
10. the LM at the same widths trained through `Module.fit` (SGD lr 0.05,
   momentum 0.9, the gradient per token, Xavier, "acc"), K1/K2/K3 held
   at 0 launches as in 9.  a. 3 fused steps at batch 2 x T 128 in
   float64, at LM_TRAIN_PARITY_LAYERS of the 12 layers (full width and
   vocabulary), card vs CPU: the losses, the embed_weight gradient (lookup
   plus tied head), each step's parameters and momenta from the CPU's
   state; in fp32 each device's step from the float64 state (the card
   as close as the CPU).  b. the lane at batch 8 x T 1024 (n_ctx) in
   fp32, TF32 off, one resident batch, 4 warm + 8 timed steps: tokens/s,
   step ms, peak memory, `mfu` (67 TFLOP/s); then the same with elastic
   checkpoints every 4 batches: the snapshot call's ms, the background
   write's seconds and bytes, the slowdown.  d. one warm step under
   torch.profiler by kernel class, and attention, the head with
   SoftmaxOutput and the one-hot timed alone.  e. the checkpoint served
   by `DecodeEngine`, prefills held to the trained Module's forward.
   c. child processes at 2 layers, batch 4 x 256, deterministic
   algorithms: an uninterrupted fit, one SIGKILLed after batch 8, one
   sent SIGTERM at batch 5 (exit 143, a final snapshot), and resumes
   from both, equal to the uninterrupted fit bit for bit.
11. BASELINE config #4, lstm_bucketing.py's bucketed LSTM language model
   (2 layers of 200, embed 200, vocab 10000, batch 32, buckets 10-60,
   SGD lr 0.01 wd 1e-5, Xavier, Perplexity(0)) on its synthetic corpus
   of 2000 sentences, through `BucketingModule.fit`; K1/K2/K3 held at 0
   launches as in 9.  a. 6 steps over buckets 60, 20, 40, 20, 60, 10
   through every bucket's fused step, card against the CPU from the
   same parameters and batches (fp32, TF32 off, momentum 0.9 so the
   shared momenta count): losses, and every bucket's parameters, begin
   states and the momenta, free running and each step from the CPU's
   state.  b. the RNN op (FusedRNNCell, `--fused`) at T 60: cuDNN's
   route against the plain loop on the card, forward and the gradient
   of every input, both timed; one fused-cell step counted on cuDNN's
   route.  c. one epoch of the config: tokens/s, step ms per bucket,
   peak memory, the fused step's declines, perplexity falling; then
   bench.py's fixed-35 LSTM lane through `Module.fit`.  d. one warm
   bucket-60 step under torch.profiler.  e. `_while_loop` (padded, and
   stopping early) and `_cond`, card against CPU.

12. BASELINE config #2, train_imagenet.py's ResNet-50 (symbols/resnet.py:
   pre-activation v2, bn_data with fix_gamma, copied onto mx.sym) fed
   from a .rec by `ImageRecordIter` and the h2d ring (`io_plane`); K1/K2/
   K3 held at 0 launches as in 9.  a. a corpus of 1024 images at 256 x
   320 (labels i % 1000) packed by the port's recordio, JPEG where a
   codec imports (else PPM, said so); the native IO library built from
   src/io_native.cc (a failed build fails the phase); bit for bit: the
   native finish against the numpy finish (fp32 and uint8), the ring's
   card batches against the iterator's host batches, uint8 + the
   ImageNormalize op on the card against the host fp32 finish.  b. 3
   fused steps at batch 4, 224, float64, on the iterator's batches, card
   vs CPU (7a's gates and max-pool excuse).  c. the config at the
   example's defaults (fp32, batch 128, SGD lr 0.1 momentum 0.9 wd 1e-4,
   Xavier, acc + top-5, Speedometer, kvstore "device", resize 256,
   rand_crop, rand_mirror, shuffle, the mean, preprocess_threads = the
   host's cores) through `Module.fit` for 2 epochs of 8 batches, the
   second timed, with the fp32 wire, the uint8 wire (ImageNormalize in
   the graph) and one resident batch: images/s, `real_vs_resident`, ring
   stalls, h2d bytes a batch, peak memory; the iterator alone over 2
   epochs.  d. two warm steps on ring batches under torch.profiler: busy
   share, host ms, the h2d copies, their streams and how much of them
   overlaps the steps' kernels.
13. BASELINE config #5, train_ssd.py's SSD-VGG16 (VGG16-reduced at full
   width, 4 feature scales, MultiBoxPrior/MultiBoxTarget, SoftmaxOutput
   and MakeLoss(smooth_l1) heads, MultiBoxDetection in every forward;
   copied onto mx.sym); K1/K2/K3 held at 0 launches as in 9.  a. every
   ported detection, spatial and deformable op on the card against the
   CPU at the SSD's shapes (anchors within 1 ulp; MultiBoxTarget and
   MultiBoxDetection/box_nms equal outside counted near ties; ROI,
   spatial and deformable ops and their gradients within rtol 1e-5 +
   1e-6*max), the NMS route against the per-box loop on the card,
   bitwise, at N = 1108 and 5936 and on chains.  b. 3 steps at batch 4,
   128, card vs CPU, in float64 (fp32, TF32 off, printed, not held: the
   early convolutions' gradients part by more than the tolerance):
   readouts rtol 1e-3, parameters and momenta from the CPU's state (a
   flipped max-pool window excuses the blocks up to it).  c. the config
   at the example's defaults through Module.fit (3 epochs of 16 batches
   of 16, the example's metric: the fused step declines every batch),
   images/s over epochs 2-3, step ms, peak memory, CrossEntropy
   falling, the closing decode (>= 1 detection); the same with the
   metric on the card; the symbol at 300x300, batch 16 (images/s, step
   ms, peak memory).  d. one warm
   step of each lane under torch.profiler; MultiBoxTarget and
   MultiBoxDetection alone at N = 1108 and 5936 (host ms, device ms,
   launches, NMS rounds).  e. 256 rectangle images packed as JPEG with
   [2, 5, objects] labels, read back through ImageDetIter bit for bit,
   then one epoch from the pack with CreateDetAugmenter.
14. the kvstore and the parameter server, under TPU_PALLAS.  a. every
   single-process case of tests/test_kvstore.py with its values on the
   card (local and device stores, two values on the one card,
   set_updater, set_optimizer with SGD and Adam, pushpull,
   row_sparse_pull, a multi-key push, 2-bit compression over 20 pushes)
   against the same calls on the CPU: reductions, codes and residuals
   bit for bit, optimizer results rtol 1e-6 + 1e-6*max.  b. train_mnist's
   mlp on contexts [gpu(0), gpu(0)] through kvstore='device': 8 steps
   against the one-context step on the card (loss rtol 1e-5; parameters
   and momenta rtol 1e-5 + 1e-6*max; K1 4 launches a step); the same
   lane with 2-bit compression against the CPU (codes equal outside
   counted near ties, parameters rtol 1e-4 + 1e-5*max); 5 epochs
   through Module.fit (accuracy > 0.95, images/s, step ms).  c. one
   ParameterServer and two workers on the card through the port's
   launcher, Module.fit(kvstore='dist_sync') at batch 32 each for 8
   steps on the server's plane (MXNET_KVSTORE_COLLECTIVE=0), SGD on the
   server: the workers' parameters equal bit for bit
   and within rtol 1e-5 + 1e-6*max of one process at batch 64; the same
   with 2-bit compression (the push's wire bytes 1/16 of fp32's);
   steps/s, push and pull ms, the server's update ms.  d.
   examples/recommender/wide_deep.py at its defaults (copied onto the
   port: 2 shard servers, a 200000 x 16 table, batch 64, 4096 samples,
   2 epochs, lr 0.1, 4096 cache rows on the card) against the port on
   the CPU: epoch-1 losses rtol 1e-4, the tower and the whole table rtol
   1e-4 + 1e-5*max, pushes, rows, hits, misses and evictions equal;
   samples/s, the hit rate, the lookup's host and device ms, the push's
   round trip, K1's launches (1 a forward), one profiled batch.

15. the rest of the op registry and of the training API (slice 13); K2
   and K3 held at 0 launches.  a. every op name this slice registered
   (110) on the card against the port on the CPU, forward and the
   gradient of its differentiable inputs, at its users' shapes
   (Deconvolution: DCGAN's generator, batch 64, 512->256->128->64->3 to
   64x64; LRN at AlexNet's conv1 output; L2Normalization at SSD's
   conv4_3; UpSampling x2 at (16, 256, 38, 38); InstanceNorm (8, 64,
   128, 128); linalg at (16, 64, 64) in float64; others ~10^6
   elements): indexing, reshaping and ordering ops bit for bit (their
   gradients rtol 1e-5 + 1e-6*max), arithmetic rtol 1e-5 + 1e-6*max,
   products and decompositions rtol 1e-4 + 1e-5*max (gelqf and syevd by
   their products and rows up to sign); the 10 update ops with sign and
   threshold near ties counted; ctc_loss at lstm_ocr's shapes (T 80,
   batch 128, 11 classes, 4 labels), F.ctc_loss against the plain loop;
   histogram (10^6 values, 100 bins) with edge near ties counted; 10^6
   draws of every random op (mean and variance within 5 sigma, KS p >
   1e-4, the same seed the same draws, shuffle a permutation); every new
   metric's device_update on the card against its host update.  b.
   BASELINE config #4 (phase 11's copy of lstm_bucketing.py) under nag,
   signum, dcasgd and lbsgd (the example's params, --mom 0.9) and
   rmsprop (also centered), adagrad, adadelta, adamax, nadam, ftml, ftrl
   and sgld (fit's optimizer name, the example's params less momentum,
   which the nine refuse): 2 fused steps over buckets 60/20, card vs
   CPU free running and from the CPU's state
   (11a's gate: in fp32 for nag, signum, dcasgd, lbsgd, adadelta and
   ftrl, in float64 for the other adaptive ones, and for rmsprop
   centered with SoftmaxOutput's softmax in
   float64 too, beside a witness of what parts the float64 lane as
   shipped; near ties excused and counted: Signum's momentum and Ftrl's
   z at their flip; SGLD, declined by the fused step, by each step's
   gradient in float64 from the CPU's state and its noise's moments),
   the bucket-60 step's ms and tokens/s of the lanes held in fp32 and
   SGLD's, the states through dumps_states/loads_states.  c. train_mnist's mlp as a SequentialModule (data ->
   fc1 -> relu1 | fc2 -> relu2 -> fc3 -> SoftmaxOutput) under TPU_PALLAS,
   initialised with Mixed(Orthogonal, MSRAPrelu), fc1 under
   AttrScope(lr_mult=0.5), a Monitor(interval=1), acc + nll_loss + a
   CustomMetric: 8 steps on the card against one Module on the card
   (rtol 1e-5 + 1e-6*max), against the CPU (phase 6's gate), the
   monitor's statistics against the CPU's (rtol 1e-4 + 1e-5*max), K1
   twice a train forward, fc1 at half rate; 5 epochs through fit to
   accuracy > 0.95; a PythonLossModule stage for one epoch.
16. the training API's stragglers and the serving path's edges (slice
   14), K2 and K3 held at 0 launches.  a. train_mnist's mlp under
   TPU_PALLAS through `model.FeedForward`: 8 steps on the card against
   `Module.fit` on the card from the same parameters and batches (rtol
   1e-5 + 1e-6*max) and against the CPU (phase 6's gate), K1 twice a
   train forward; save, load and predict against `Module.predict`; a
   ragged 500 rows (a tail of 52) against row-by-row answers (rtol 1e-4
   + 1e-5*max).  b. the mlp trained through `Module.fit(checkpoint_dir=)`,
   a torn checkpoint newer than the valid ones beside it, served through
   `ModelServer.load_model(symbol_file=, checkpoint_dir=)` partitioned:
   the parameters the newest valid snapshot's, requests of 1-32 rows
   against `Module.predict` (rtol 1e-4 + 1e-5*max), K1 twice a served
   batch.  c. the JAX scripts of tests/test_resilience.py:467 and :489
   on the card through `resilience.faults`: two failed batches open the
   breaker, submit fails fast, the probe closes it; retries {1: 1, 2: 1};
   the counters equal the CPU's, the answers 16b's.  d. the C predict
   ABI: the shim (csrc/c_predict_api.cc) built from the checkout, a C
   program compiled with g++, run with dev_type 2 on the partitioned mlp
   at batch 32 against an in-process `c_predict` predictor (rtol 1e-6;
   K1 twice a forward), dev_type 1 against the card (rtol 1e-4 +
   1e-5*max), dev_type 7 refused.  e. config #4 at its published widths
   through `BucketingModule.fit(checkpoint_dir=)` in child processes, as
   10c: SIGKILL after batch 10 and SIGTERM at batch 24 (exit 143),
   both resumed sha256-equal to the uninterrupted fit (every bucket's
   parameters, begin states and momenta); a `Module(state_names=)` step
   on the card against the CPU (11a's gates).  f. `test_utils` on the
   card: `check_consistency` over [cpu(0), gpu(0)] on the partitioned
   mlp (K1) and lenet at the default tolerances, `check_numeric_gradient`
   in float64 for FullyConnected and Convolution, its refusal of
   SoftmaxOutput (an implicit gradient) as on the CPU, and SoftmaxOutput's
   gradient by `check_symbolic_backward`.
17. gluon's remaining layers and the model zoo (slice 15), K2 and K3
   held at 0 launches.  AlexNet (`alexnet(classes=1000)`, 224x224)
   composed on a Symbol with a SoftmaxOutput under TPU_PALLAS, so fc6
   (9216 -> 4096) and fc7 (4096 -> 4096) run K1.  a. 3 fused Module.fit
   steps at batch 8, fp32 (TF32 off), Dropout at 0, card vs CPU (phase
   6's gates; a ReLU unit or max-pool window that flips between the
   devices excuses the layers up to it at that step, and the
   free-running states after it are not held); one train forward at
   Dropout(0.5) through forward hooks: the kept share 0.5 +- 0.02, kept
   values x 2.
   b. phase 7's lane on AlexNet (bf16, fp32 master weights, batch 128,
   one resident batch, 4 warm + 16 timed steps, Dropout 0.5): images/s,
   step ms, peak memory, K1 2 a train forward, K1's share of one
   profiled step.  c. the trained parameters in the gluon block,
   hybridized and exported, the export partitioned and served through
   ModelServer at buckets 1-32 (K1 2 a batch), answers held to
   Module.predict of the export; SymbolBlock.imports of it on the card
   against the block.  d. densenet121, inception_v3 (299x299),
   mobilenet1.0, mobilenetv2_1.0, squeezenet1.0 and 1.1 at 1000 classes:
   2 hybridized Trainer steps at batch 2 in float64 card vs CPU, then a
   fp32 batch-32 lane on the card (images/s; K1 0 launches).  e. every
   new block on the card vs the CPU in fp32 (activations, Embedding,
   InstanceNorm, the transposed convolutions, ReflectionPad2D, the pixel
   shuffles, CTCLoss with gradients, LSTMPCell, the nine conv RNN cells,
   SyncBatchNorm), and the one-card SyncBatchNorm against BatchNorm.
18. gluon's data plane and `mx.contrib` (slice 16), K2 and K3 held at 0
   launches.  a. a JPEG .rec of 640 images at 256x256 (phase 12's
   writer) through `ImageRecordDataset`, the evaluation pipeline
   (Resize(256, keep_ratio), CenterCrop(224), ToTensor, Normalize with
   ImageNet's mean and std) and `DataLoader(batch 128)`: 8 workers = 0
   workers bit for bit, in order; through
   `io_plane.DevicePrefetchLoader(ctx=gpu(0))` the card's batches = the
   host's; an `ImageFolderDataset` tree of 64 PNGs decodes to its pixels
   and labels; a sample that raises surfaces at its batch within 5 s; no
   worker alive 10 s after an iterator dropped mid-epoch; the training
   pipeline's images/s over a whole epoch (RandomResizedCrop(224),
   RandomFlipLeftRight, the three jitters of 0.4) at 0 and 8
   workers, with the first batch's wait and the host cores kept busy,
   beside phase 12's `ImageRecordIter`.  b. AlexNet composed under TPU_PALLAS fed by
   `contrib.io.DataLoaderIter` into `Module.fit`: 3 fp32 steps at batch
   8 against `NDArrayIter` over the same host batches (cuDNN
   deterministic: bit for bit, else 17a's gate); then 17b's lane (bf16,
   Dropout 0.5) for 2 epochs at batch 128 with the data cast to bf16 on
   the workers: K1 2 a train forward, images/s and `loader_vs_resident`
   against 17b.  c. the gluon AlexNet (Dropout 0), bf16, hybridized,
   through `Estimator.fit` over the loader with MXNET_IO_RING on: the
   fused gluon step and the ring take every batch; images/s.  d. the
   gluon `TransformerLM` at GPT-2 small's widths (phase 10's Xavier):
   3 plain-loop steps (record, backward, `Trainer.step`, SGD lr 0.05
   momentum 0.9) at 2 x T 128 in float64 card vs CPU (the losses, the
   tied embed_weight gradient, every parameter and momentum, 10a's
   gates); `Estimator.fit` with the fused step on the card = the plain
   loop; the 8 x 1024 lane fed by a `DataLoader(num_workers=2)` of
   seeded token windows through `DevicePrefetchLoader`, fp32 fused and
   eager and bf16 fused: tokens/s, step ms, mfu, peak memory,
   `fused_vs_eager` and `gluon_vs_module` against 10b; K1/K2/K3 0
   launches.  e. train_mnist's mlp under TPU_PALLAS through
   `contrib.svrg_optimization.SVRGModule` (batch 64, update_freq 2,
   SGD without momentum): 8 steps card vs CPU (phase 6's gate), then 4 epochs with
   `contrib.tensorboard.LogMetricsCallback`: the loss falls, K1 exactly 2
   a forward (two forward-backward passes a step, one a batch in each
   snapshot pass), one metric record a batch.
19. sparse storage, ONNX and INT8 (slice 17), K2 and K3 held at 0
   launches.  a. 1024 seeded LibSVM rows at 1 000 000 features (the
   width of upstream MXNet's example/sparse/linear_classification, 15
   a row) through `LibSVMIter`: a CSR batch of 256 densified on the card
   from its parts = the generator's rows bit for bit; FullyConnected(2)
   + SoftmaxOutput through `Module.fit` for 4 steps on the card (the h2d
   ring carries the parts: bytes a batch printed) against the CPU (rtol
   1e-5 + 1e-6*max), the bound input after the last step = its rows;
   `sparse.dot(csr, w^T)` on the card against the dense product; the
   weight's touched rows as row_sparse through a .params bit for bit.
   b. VGG-16 at full width (phase 4's symbol with its nodes named,
   seeded weights) exported to ONNX and imported by the port (seconds,
   bytes), partitioned with TPU_PALLAS, saved as a checkpoint pair and
   served through ModelServer: answers held to the original symbol on
   the card with phase 4's gate, K1 2 a dispatched batch; ResNet-50 v1
   (BatchNorm with seeded statistics, the adds, global pooling) round
   trip forward on the card against the original, K1 0 launches.  c. the
   int8 FC route (a float64 GEMM) at M = 1, 8, 17, 32, K = 4096 exact,
   beside an fp32 GEMM and `torch._int_mm`; the same VGG-16 through
   `quantize_model(calib_mode="naive")` over 32 seeded images with fc6
   and fc7 excluded (13 convolutions, 5 poolings and fc8 int8), served
   under TPU_PALLAS (K1 2 a batch at fc6 and fc7) and held to the CPU's
   int8 graph: the answers may differ only by what flipping fc8's
   inputs within 1e-3 of a .5 step could move (counted; K1 and the CPU
   sum fc6 and fc7 in other orders); the int8 tensors of one request
   card vs CPU counted; int8 vs fp32 logits and top-1, calibration
   seconds, bucket-32 images/s of the fp32 and int8 servers.
20. the serving fleet (slice 18), K2 and K3 held at 0 launches; worker
   processes and host daemons start after the build (READY builds=0)
   with TF32 off (NVIDIA_TF32_OVERRIDE=0) and MXNET_PS_RECONNECT_WAIT
   0.5 s.  a. phase 4's VGG-16 and weights as a checkpoint pair behind
   a `ReplicaRouter` over two `LocalReplica`s on gpu(0) and two
   `RemoteReplica.spawn` workers on the card (shed thresholds out of
   reach): 4 clients x 40 requests of 1-4 images, the classes in turn,
   one worker SIGKILLed after the 40th accepted: all 160 answered, one
   replica lost, no rid executed twice among the survivors, each answer
   against an in-process `ServedModel` (phase 4's gate), K1 2 a served
   batch and deepcheck in process and in the surviving worker (its
   stats); requests/s, p50/p99 by class, the time to declare the worker
   dead.  b. `swap_weights(checkpoint_dir=)` from an elastic checkpoint
   of a second seeded weight set over the three survivors under 2
   clients: none dropped, each answer wholly the old or the new
   weights', every survivor swapped, ladders unchanged, builds 0.  c. a
   `FleetManager` over two `AgentHost.launch_local` daemons (min 1, max
   3; tick 0.2 s, up after 1 s, down after 2 s, cooldown 1 s; heartbeat
   0.25 s, deadline 2 s; SLO 3x a lone 4-image request): a ramp of 8
   clients scales up onto the emptier host, one host's process group is
   SIGKILLed under 2 light clients: declared dead within the deadline +
   a tick, its replicas lost, the survivor backfills, idleness retires a
   replica through the drain, no admitted interactive request lost,
   every spawn builds=0; the actions, backfill latency and findings.
   d. two `DecodeReplica`s at phase 9's widths under a router, 12
   sequences, one replica killed with its slots active: every sequence
   completes once, equal to phase 9's static lane through the survivor's
   programs where its chain is clear of near ties.  e. wide_deep's table
   at its defaults on 2 shard-server processes, 4096 cache rows on the
   card, through `EmbeddingServingPath` in front of its tower (K1 at
   deep1) served by a router over two `LocalReplica`s: 4 clients x 25
   requests of 64, one shard server SIGKILLed after the 30th and
   respawned by ``on_shard_lost``: none lost, answers against the
   in-process tower on the same rows (rtol 1e-5 + 1e-6*max), K1 1 a
   tower forward.  Phase 20 runs traced: MXNET_OBS_TRACE names one span
   file that this process and every worker, host daemon and shard server
   appends to.
21. the telemetry plane (slice 19), on phase 20's processes.  a. the span
   file merged by tools/mxtrace.py: zero orphans; each of 20a's answered
   requests one `router.request` root whose tree holds the answering
   replica's span (`worker.infer` in that worker's pid, or the
   in-process replica's `batcher.execute`, or the batch that lists the
   request's rid when it was coalesced into another's); the requests
   that failed over off the SIGKILLed worker end ok under their original
   trace ids.  b. inside 20c, with one host down and the traffic stopped:
   `FleetManager.scrape()` does not raise, lists the dead host and its
   replicas under ``unreachable``; the survivors' ``worker.executed``
   equal their stats(), every Prometheus text parses, and K1 is 2 a
   forward in each.  c. phase 4's server (20a's checkpoint) under
   `profiler.set_state("run")` for 4 bucket-32 batches with a Task, a
   Frame, a Counter and a Marker: the dumped chrome trace loads as JSON
   with the custom events and CUDA kernels, `dumps()` holds the per-op
   table, `record_memory` reads bytes in use; K1's kernels in the trace
   against its launches, printed.  d. the same server's requests/s and
   p50/p99 with tracing off and on (lanes off, on, on, off), and
   `calibrate_span_cost()`, printed.
22. the training guardian and the train-to-serve loop (slice 20).  The
   guardian is on by default, so every Module.fit above runs it.  a.
   train_mnist's mlp (K1 at fc1 and fc2) through Module.fit with
   checkpoints, the guardian polling every 4 steps: an injected
   ``grad.nonfinite`` step skipped (two seeded runs sha256-equal, the
   parameters finite); a NaN batch refused with the guardian on and
   poisoning the parameters with MXNET_GUARDIAN=0; an injected
   ``loss.spike`` rolled back (sha256-equal to a clean run over the same
   quarantine); `TrainingDivergedError` past MAX_FAILURES naming step,
   signal and shard; a resumed run skipping the quarantined position;
   the skips, the rollback and its window, the quarantine and the
   divergence equal to the same runs on the CPU.  b. 17b's AlexNet lane
   (bf16, batch 128, K1 at fc6/fc7) through Module.fit with the
   guardian off, on, on, off, and phase 6's mlp fit off and on:
   images/s, step median and peak memory; one warm AlexNet step
   profiled unguarded and guarded; each part of the added device time
   (copy, norms, select, displacement) timed with CUDA events beside
   the bytes it moves; the guarded fused step's synchronizing calls
   between polls (torch.cuda.set_sync_debug_mode('warn')) no more than
   the unguarded step's.  c. a trainer thread fine-tuning AlexNet's fc6,
   fc7 and classifier (fp32, K1 at fc6/fc7) through Module.fit with
   checkpoints and a `CheckpointPublisher` into a `ModelRegistry`, from
   a boot model below the task's ceiling; a `LoopController` canarying
   each version (the mean log-likelihood of the true class on 128
   holdout images, tol 0.02) on one of two `LocalReplica`s behind a
   `ReplicaRouter` (AlexNet, K1, buckets 1-32 and 128) and promoting it
   with `swap_weights` while 2 clients send requests; the last
   promotion above the boot model's score; a torn ``publish.commit``
   invisible and published again; a degraded version (the classifier
   scaled by 0.25) and a poisoned one (negated) rejected, swapped back
   and stamped, never on the other replica; no admitted request lost;
   ``loop.freshness_lag_s`` within its SLO in a scrape of this
   process.  d. K1's launches on each
   path (guardian_fit, alexnet_guarded, loop_trainer and loop_replicas by
   the launching thread) into the kernels line.
23. the elastic supervisor, the collective data plane and fit's failover
   (slice 21).  a. the port's launcher starts 2 workers on the card with
   MXNET_KVSTORE_COLLECTIVE unset (the collective plane: a gloo group,
   since the two share the card): 14c's mlp lane through
   Module.fit(kvstore='dist_sync'), the workers' parameters equal bit for
   bit and within DP_TOL of one process on the global batch, one
   all-reduce a step after the keys' init, no push on the server, K1
   twice a step; then 17b's AlexNet (Dropout 0.5) in fp32 at batch 128 =
   2 x 64: each timed step's all-reduce ms, bytes (one fp32 bucket) and
   GB/s through gloo, steps/s against 17b's rate, the workers equal.  b.
   one worker's dist_sync fit of the mlp with a snapshot a batch: the
   server crashed at batch 7 and replaced empty on its port; fit raises
   ServerLostError inside, resumes from the last checkpoint and ends
   sha256-equal to a clean run; the time from the crash to the first
   resumed step.  c. 3 `dist.pod_worker` processes (the mlp, batch 32,
   the socket plane), rank 2 killed at its 4th step (host.step:kill):
   the survivors see it dead within the deadline + 2 s, their stalled
   round raises CollectiveTimeoutError naming [2], they shrink to world
   2 at epoch 1 and resume, PARAMS_SHA equal to a 2-worker control
   resumed from the same checkpoint; detection, shrink barrier and
   restart seconds.  d. gluon.Trainer over AlexNet (Dropout 0, K1 at
   fc6/fc7 through a partitioned SymbolBlock) in bf16 on [gpu(0),
   gpu(0)], half of each batch of 128 a replica, through the bucketed
   store at 32 MB: each step from one context's state at the whole
   batch, the fp32 masters' displacement within rtol 2**-6 + 2**-6*max;
   one reduction a bucket; buckets, fill and the reduce's ms a step.
   K1's launches on each path (dist_collective, dist_failover,
   pod_workers, trainer_multi_ctx) into the kernels line.

24. the small public modules and the mesh (slice 22): a. in process,
   AlexNet (Dropout 0, TPU_PALLAS: K1 at fc6/fc7) fp32 at batch 32
   under a `CustomOp` softmax head with a hand-written backward against
   the built-in SoftmaxCrossEntropyLoss, every gradient of 3 steps from
   the same parameters within rtol 1e-5 + 1e-6*max; AlexNet's
   parameters initialised on the card inside `engine.bulk`, bit for bit
   the unbulked ones, in one host-to-device copy; NaiveEngine naming a
   failing op at dispatch; `mx.viz.print_summary(alexnet)` and its total;
   `libinfo.features()`.  b. one group of 4 gloo ranks sharing the card
   through `parallel.initialize_distributed`: torch.distributed's verbs
   on the card's tensors (point-to-point staged through the host) and
   `parallel`'s verbs, exact; `data_parallel_step` and `zero_train_step`
   (Adam) at dp=4 against one rank; `pipeline_step` at pp=4 and
   `pipeline_train_step` at pp=2 against the sequential composition;
   the tentpole lane: AlexNet at full width on dp=2 x tp=2, fc6/fc7
   column-parallel over tp (K1 on each rank's (16, 9216 -> 2048) and
   (16, 4096 -> 2048) shards), the batch of 32 over dp, Adam with ZeRO
   over dp, 3 steps with cuDNN off against one process at the whole
   batch from the same state (loss rtol 1e-3; gradients rtol 1e-5 +
   1e-6*max; parameters and Adam state rtol 1e-3 + 1e-4*max; outside
   the fc6/fc7 units whose ReLU flipped and, for the state, the elements
   whose two gradients both lie within their tolerance of 0, counted and
   capped), then one step with cuDNN on (loss rtol 1e-3; gradients
   within that tolerance plus 3x cuDNN's own error between the batch's
   dp halves and the whole batch in one process);
   SyncBatchNorm at dp=4 against one rank at the whole batch.  c.
   `Module` over [gpu(0), gpu(0)] with mesh='dp=2': train_mnist's mlp 8
   steps against one context (14b's gates) and `fit(mesh='dp=2')` 2
   epochs (accuracy > 0.95).  K1's launches on each path (custom_op_head,
   tensor_parallel, module_mesh) into the kernels line.

The last two lines are a JSON object of per-kernel measurements and the
result line ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the port's package beside it, the script exits non-zero and
prints no result.  It takes no arguments.
"""
from __future__ import annotations

import collections
import gc
import json
import math
import os
import random
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

SEED = 0
VGG_FC_SHAPES = ((25088, 4096), (4096, 4096))   # (K, N) of fc6, fc7
BUCKETS = (1, 2, 4, 8, 16, 32)
# K1's rows in phase 3: the serving buckets, and the batches a training
# step of the classifier runs (64: AlexNet's half batch on a worker of
# 23a and a context of 23d)
K1_ROWS = BUCKETS + (64, 128)
# phase 3's route gate: the route the library takes may spend at most this
# factor times the other route's profiler device time, plus this many ms
K1_ROUTE_GATE = (1.10, 0.001)
# train_mnist's mlp at batch 64: fc1+relu1 and fc2+relu2, in fp32
MLP_K1 = ((64, 784, 128), (64, 128, 64))
# K1 on phase 14's paths, in fp32: the mlp's fc1 and fc2 in each executor
# of 14b (batch 64 over two contexts) and in each 14c worker (batch 32),
# and the wide_deep tower's deep1 (14d)
PATH_K1 = (((32, 784, 128), "dp_fc1", "executor fc1"),
           ((32, 128, 64), "dp_fc2", "executor fc2"),
           ((64, 32, 32), "wd_deep1", "wide_deep deep1"),
           # phase 24b: AlexNet's fc6 and fc7 column halves at the dp half
           # of a batch of 32, each tp rank's K1
           ((16, 9216, 2048), "tp_fc6", "tp shard fc6"),
           ((16, 4096, 2048), "tp_fc7", "tp shard fc7"))
# phase 16's mlp paths: 16b/16c serve it at these buckets, 16d's predictor
# runs it at C16_BATCH and 16f's check_consistency at UTILS16_BATCH; fc1
# and fc2 at each of these batches not held above join PATH_K1
SERVE16_BUCKETS = (1, 2, 4, 8, 16, 32)
C16_BATCH = 32
UTILS16_BATCH = 16
MLP_LAYERS = (((784, 128), "fc1"), ((128, 64), "fc2"))
PATH_K1 += tuple(
    ((m, k, n), f"mlp{m}_{layer}", f"mlp {layer} at batch {m}")
    for m in sorted(set(SERVE16_BUCKETS) | {C16_BATCH, UTILS16_BATCH})
    for (k, n), layer in MLP_LAYERS
    if (m, k, n) not in MLP_K1 + tuple(shape for shape, _, _ in PATH_K1))
# phase 6: train_mnist's defaults (examples/image_classification/
# train_mnist.py:69-100, :60-66)
# train_mnist's defaults but for its epochs: 5 of its 10 (a cut of depth
# to take back chip time; phase 6, 14b and 15c's fits reached accuracy
# 1.0000 at 10)
TRAIN_IMAGES, TRAIN_SPLIT, TRAIN_BATCH, TRAIN_EPOCHS = 4096, 3584, 64, 5
TRAIN_LR, TRAIN_MOMENTUM = 0.05, 0.9
PARITY_STEPS = 8
# card vs CPU over 8 steps, TF32 off: fp32 sums in other orders (3xTF32
# in K1) through momentum SGD; the loss per step and every parameter
PARITY_TOL = (1e-3, 1e-4)
# served fp32 answers vs Module.predict: the served graph is the saved,
# unpartitioned one (cuBLAS FC+ReLU) and predict's runs K1, so fp32 sums
# in other orders
SERVE_TRAIN_TOL = (1e-4, 1e-5)
# bf16 serving vs the fp32 answers: each layer's output rounded to bf16
# (2**-8 relative), compounding over three layers and the softmax
SERVE_BF16_TOL = (2.0 ** -5, 2.0 ** -6)
# the kernels a K1 call launches (split_tf32 and splitk_epilogue where the
# plan needs them), for the profiler's device time
K1_KERNELS = ("fc_relu_kernel", "fc_relu_tc", "split_tf32", "splitk_epilogue")
IMAGE = (3, 224, 224)
CLASSES = 1000
# the load: CLIENTS threads, each sending REQUESTS_PER_CLIENT requests of
# 1-8 rows one after another (a closed loop); then one request at a time
# of SOLO_ROWS rows, each dispatched alone into its own bucket
CLIENTS = 32
REQUESTS_PER_CLIENT = 24
SOLO_ROWS = (1, 2, 3, 5, 12, 27)        # buckets 1, 2, 4, 8, 16, 32
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; FLOP/s by type.
# bf16 and fp16 on the tensor cores.  fp32: the least time for fp32-exact
# work is on the tensor cores too, in three TF32 passes (3xTF32): 495/3 =
# 165 TFLOP/s, above the CUDA cores' 67 (against which a 3xTF32 kernel
# could read over 100 % of its bound).  K1's fp32 bound is set by bytes at
# M <= 32 either way.
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 165e12, torch.bfloat16: 989e12,
              torch.float16: 989e12}
# fp32: the kernel and the plain version add the same fp32 products in
# different orders (the tensor-core route's 3xTF32 products ~2**-21
# relative each); with unit-scale outputs over K <= 25088 terms the
# rounding difference is ~1e-5.  bf16: both round an fp32 sum to bf16,
# which may land one bf16 ulp (2**-8 relative) apart; fp16 the same with
# 3 more mantissa bits (2**-11).
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 1e-4),
       torch.float16: (2.0 ** -9, 1e-4)}
# serving vs the unpartitioned graph: the padded bucket and the exact
# request batch let cuDNN pick different fp32 conv algorithms, whose
# rounding compounds over 16 layers
SERVE_TOL = (1e-3, 1e-3)
BF16 = torch.bfloat16
F16 = torch.float16
F32 = torch.float32
# fc_relu.cu's kTcMinRows: the rows from which the library takes
# tensor_core at VGG-16's and AlexNet's classifier weights
K1_TC_MIN_ROWS = {F32: 8, BF16: 2, F16: 2}
# the JSON line's shapes: fc6 at bucket 32, the bucket of the served load,
# in fp32 (the served dtype) and, under keys of its own, bf16
REP = (32, 25088, 4096, F32)
REP_BF16 = (32, 25088, 4096, BF16)
# phase 3b: (label, (B, T, H, D), dtype, causal, (q_off, k_off),
# MXNET_FLASH_VMEM_MB or None for the default, the route it must take)
ATTN_CASES = [
    ("long-context", (2, 8192, 8, 64), BF16, True, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), BF16, False, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), F32, True, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), F32, False, (0, 0), None, "whole"),
    ("long KV", (1, 32768, 1, 64), BF16, True, (0, 0), None, "whole"),
    ("long KV", (1, 32768, 1, 64), BF16, True, (0, 0), "4", "stream"),
    ("long KV", (1, 32768, 1, 64), F32, True, (0, 0), None, "stream"),
    ("ring below", (2, 2048, 8, 64), BF16, True, (2048, 0), None, "whole"),
    ("ring diagonal", (2, 2048, 8, 64), BF16, True, (2048, 2048), None,
     "whole"),
    ("ring above", (2, 2048, 8, 64), BF16, True, (0, 2048), None, "whole"),
    ("ragged", (2, 1000, 8, 64), F32, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 64), BF16, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 128), F32, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 128), BF16, True, (0, 0), None, "whole"),
    ("wide head", (2, 8192, 8, 128), BF16, True, (0, 0), None, "whole"),
    ("packed qkv", (2, 2048, 8, 64), BF16, True, (0, 0), None, "whole"),
    # two column groups of O; fp32's 16.8 MB of K and V take K3
    ("widest head", (2, 8192, 8, 256), F32, True, (0, 0), None, "stream"),
    ("widest head", (2, 8192, 8, 256), BF16, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 136), BF16, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 136), F32, True, (0, 0), None, "whole"),
    ("long-context", (2, 8192, 8, 64), F16, True, (0, 0), None, "whole"),
    ("long KV", (1, 32768, 1, 64), F16, True, (0, 0), "4", "stream"),
    # past D = 256: the CUDA-core route, 4 column groups of O at 512
    ("head 512", (2, 2048, 8, 512), F32, True, (0, 0), None, "whole"),
    ("head 512", (2, 2048, 8, 512), BF16, True, (0, 0), None, "whole"),
    ("head 512", (2, 2048, 8, 512), F16, True, (0, 0), None, "whole"),
    ("head 512", (2, 2048, 8, 512), F32, True, (0, 0), "0.001", "stream"),
    ("ragged", (2, 1000, 8, 264), F32, True, (0, 0), None, "whole"),
    ("ragged", (2, 1000, 8, 264), BF16, True, (0, 0), None, "whole"),
]
# the JSON line's cases: the ones phase 5 runs through each kernel
REP_K2 = ("long-context", (2, 8192, 8, 64), BF16, True, (0, 0), None)
REP_K3 = ("long KV", (1, 32768, 1, 64), BF16, True, (0, 0), "4")
# and their fp32 cases (the 3xTF32 route), under keys of their own
REP_K2_F32 = ("long-context", (2, 8192, 8, 64), F32, True, (0, 0), None)
REP_K3_F32 = ("long KV", (1, 32768, 1, 64), F32, True, (0, 0), None)
# kernel vs plain version.  fp32: the same terms, up to 32768 of them,
# summed in other orders, each product 3xTF32 (~2**-21 relative; ~1e-5
# relative in all).  bf16: o is rounded to bf16 (2**-8 relative), and
# each p is rounded to bf16 against a running max that depends on the
# tiling (the kernel's 64-key tiles or split ranges vs the plain
# version's 256-key blocks), noise of 2**-9 of each p*v term that reached
# 0.0044*max|o| in a CPU emulation of the split.  fp16: the same with 3
# more mantissa bits.
ATTN_TOL = {F32: (1e-4, 1e-5), BF16: (2.0 ** -6, 2.0 ** -7),
            F16: (2.0 ** -8, 2.0 ** -9)}
# the port's normalised output vs SDPA: SDPA picks its own backend,
# whose fp32 path may round like TF32 (~1e-3); 16-bit: o rounded twice
# (o, then o / l) against SDPA's once
SDPA_TOL = {F32: (2e-3, 2e-3), BF16: (2.0 ** -6, 2.0 ** -7),
            F16: (2.0 ** -7, 2.0 ** -8)}
# phase 5, the bf16 kernel path against fp32 T x T attention: out is
# rounded to bf16 twice (o, then o / l) and its gradients are rounded
# to bf16 after an fp32 backward that starts from the bf16 out, so
# 2**-6 relative plus 2**-6 of the largest value; fp32: sums of 32768
# terms in other orders (1e-5), with the backward's rowsum(dO*O)
# shortcut against autograd's softmax backward, 1e-3
PATH_TOL = {BF16: (2.0 ** -6, 2.0 ** -6), F32: (1e-3, 1e-4)}
PATH_BLOCK = 512      # block_q, block_k of phase 5 (the repo's long-context
                      # configuration, tests_tpu/test_flash_perf.py)
# phase 7: the BASELINE lane (bench.py:165-211, defaults :683-687): gluon
# resnet50_v1(classes=1000) composed on Variable("data") + SoftmaxOutput,
# 3x224x224, batch 128, bf16 data, SGD lr 0.05 momentum 0.9 with
# multi_precision and rescale_grad 1/batch, Xavier(gaussian, in, 2), "acc";
# one device-resident random batch (bench.py:97-134)
RESNET_BATCH, RESNET_WARM, RESNET_TIMED = 128, 8, 24
RESNET_FP32 = (32, 16)        # (batch, steps) of the fp32 run of the lane
RESNET_PARITY = (4, 2)        # (batch, steps) of the card against the CPU
RESNET_SERVE = (8, 4)         # (batch, steps) of the checkpoint it serves
RESNET_SERVE_SIZES = (1, 3, 8, 2, 5, 7, 4)
RESNET_BUCKETS = (1, 2, 4, 8)
RESNET_OPT = {"learning_rate": 0.05, "momentum": 0.9}
# a bias that feeds a BatchNorm has a zero gradient in exact arithmetic
# (the normalisation removes a constant shift): in float64 it and its
# momentum stay rounding noise (~1e-14), held below this
RESNET_ZERO = 1e-9
# phase 7a float32: the card's distance from the float64 step at most
# this factor times the CPU's, plus this much
RESNET_ENVELOPE = (3.0, 1e-6)
# phase 8: gluon's imperative training.  BASELINE config #3 ("Gluon
# hybridize() ResNet-v2 from gluon.model_zoo.vision") through the plain
# record / backward / Trainer.step loop, and bench.py's gluon lane
# (`_run_gluon`, bench.py:214-290, defaults :683-687): resnet50_v1 in bf16
# through Estimator.fit and the fused gluon step, batch 128, SGD lr 0.05
# momentum 0.9 multi_precision, rescale_grad 1/batch (on top of step's
# 1/batch), Xavier(gaussian, in, 2), Accuracy, one resident random batch
GLUON_WARM, GLUON_TIMED = 8, 24       # the bench lane (Estimator.fit)
V2_WARM, V2_TIMED = 8, 24             # BASELINE #3 (hybridized, plain loop)
V2_EAGER = (4, 12)                    # the same loop, not hybridized
GLUON_PARITY = (4, 2)                 # (batch, steps) card vs CPU, float64
# one card step hybridized vs eager in float64: the same ops in the same
# order, so only a fault moves them apart
HYBRID_TOL = (1e-9, 1e-12)
V2_PREFIX = "resnetv2_"   # a fixed prefix: every instance, the same names
# fp32 outside the tensor cores (TF32 is off), the fp32 lane's peak
FP32_CUDA_CORE_FLOPS = 67e12
# device kernels by class in the profile of one bf16 step (first match)
KERNEL_CLASSES = (
    ("BatchNorm", ("batch_norm",)),
    ("optimizer update and aux copy (multi-tensor)", ("multi_tensor",)),
    ("metric (argmax, compare)", ("argmax", "ArgMax")),
    ("SoftmaxOutput", ("softmax", "Softmax")),
    ("pooling", ("pool",)),
    ("convolution and FC (cuDNN, cuBLAS, layout)",
     ("conv", "xmma", "implicit", "gemm", "cudnn", "cutlass", "nchw",
      "nhwc", "sm90", "wgrad", "dgrad", "fprop", "nvjet")),
    ("reductions (bias gradients, sums)", ("reduce_kernel",)),
    ("elementwise (add, relu, casts, fills)",
     ("elementwise", "vectorized", "unrolled", "fill", "copy")),
)


# phase 9: the transformer LM (llm/) served at GPT-2 small's published
# widths (Radford et al. 2019; the Hugging Face `gpt2` config: n_layer 12,
# n_head 12, n_embd 768, n_ctx 1024, vocab_size 50257), ffn_mult 4; the
# repo's LM has no position embedding and exact gelu, so these are GPT-2
# small's widths, not GPT-2.  eos outside the vocabulary: every sequence
# spends its budget (tools/run_lm_bench.py:50-53)
LM_CFG = dict(vocab_size=50257, num_layers=12, num_heads=12, hidden=768,
              ffn_mult=4, max_len=1024, eos_id=-1)
LM_SLOTS = 8
LM_BUCKETS = (8, 64, 256)
LM_STD = 0.02                 # GPT-2's initializer range
LM_PROMPTS = (5, 50, 200)     # 9a: one prompt per bucket, into slots 0-2
LM_TICKS = 8                  # 9a: teacher-forced decode ticks
# 9a: card vs CPU in fp32 (TF32 off): sums in other orders through 12
# layers and a 50257-way head
LM_TOL = (1e-3, 1e-4)
# a near tie: a top-2 margin at most this share of max|logit|; argmax is
# held only where the margin is larger
LM_TIE = 1e-3
# 9a bf16 (parameters and cache) vs fp32 on the card: each op's output
# rounded to bf16 (2**-8) through 12 layers; the relative L2 of the
# logits, and the margin past which argmax must agree
LM_BF16 = 2.0 ** -5
# 9b: tools/run_lm_bench.py's trace (:82-96, seed 17): groups of 8, seven
# budgets of 3 new tokens and one of 40, prompts of 2-8 tokens; then
# LM_LONG sequences of 9-256 prompt tokens (buckets 64 and 256) with
# budgets of 16-64, submitted by LM_CLIENTS threads
LM_GROUPS, LM_SHORT_NEW, LM_LONG_NEW = 6, 3, 40
LM_LONG = 16
LM_CLIENTS = 8
# 9c: device time by class of one profiled tick, by the inclusive device
# time of the ops the decode plane calls (first match)
LM_OP_CLASSES = (
    ("GEMM (qkv, out_proj, fc1, fc2, head)", ("aten::linear",)),
    ("attention softmax/einsum", ("aten::einsum", "aten::softmax",
                                  "aten::masked_fill", "aten::amax",
                                  "aten::exp", "aten::sub", "aten::sum",
                                  "aten::maximum", "aten::mul",
                                  "aten::where", "aten::full",
                                  "aten::zeros")),
    ("LayerNorm", ("aten::layer_norm",)),
    ("gelu", ("aten::gelu",)),
    ("cache write", ("aten::index_put_", "aten::copy_")),
)
# phase 10: the LM at LM_CFG's widths trained through Module.fit as
# tests/test_llm.py `_fit_lm` trains it (SGD lr 0.05, momentum 0.9,
# Xavier, "acc"), with elastic checkpoints.  SoftmaxOutput sums the
# gradient over the B*T tokens (normalization "null"), so the gradient is
# rescaled by 1/(B*T), the per-token mean (`lm_opt`): the Module's
# default 1/B is T times larger, 85x _fit_lm's T = 12 at n_ctx, and
# diverged to NaN within 10 steps in a CPU rehearsal at T = 256
LM_TRAIN_OPT = {"learning_rate": 0.05, "momentum": 0.9}
LM_TRAIN_PARITY = (2, 128, 2)       # 10a: batch, T, steps (float64)
# 10a's and 18d's float64 parities run this many of GPT-2 small's 12
# layers, at its full width and vocabulary (a cut of depth: the CPU's
# float64 steps took 62 s of 10a and 53.4 s of 18d at 12 layers)
LM_TRAIN_PARITY_LAYERS = 1
LM_TRAIN_LANE = (8, 1024, 4, 8)     # 10b: batch, T (n_ctx), warm, timed
LM_CKPT_PERIOD = 4                  # 10b: processed batches per snapshot
# 10a float32: each device's step from the float64 CPU state, at most
# this factor times the CPU's distance from the float64 step, plus this
LM_TRAIN_ENVELOPE = (3.0, 1e-6)
# 10c: reduced depth (2 layers at width 768, the full vocabulary), batch
# 4 x 256, 2 epochs of 6 shuffled batches, a snapshot every 2 batches;
# SIGKILL after batch 8 (mid epoch 1), SIGTERM once batch 5 is done.  A
# cut to 1 layer and epochs of 4 batches took nothing back (the
# children's 54.9 s became 58.3 s on another card: five process starts
# bound them), so the depth stays
LM_RESUME = dict(layers=2, batch=4, t=256, batches=6, epochs=2, period=2,
                 kill_after=8, term_after=5)
LM_RESUME_ENV = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
# 10d: device kernels of one training step by class (first match)
LM_TRAIN_CLASSES = (
    ("GEMM (the FCs, the head, attention's einsum)",
     ("gemm", "sgemm", "xmma", "cutlass", "nvjet", "gemv", "splitK")),
    ("softmax (attention and the head)", ("softmax", "SoftMax")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("the update (multi-tensor SGD)", ("multi_tensor", "foreach")),
    ("reductions (bias gradients, sums, argmax)", ("reduce_kernel",)),
    ("elementwise (one-hot, masks, gelu, casts, copies)",
     ("elementwise", "vectorized", "unrolled", "fill", "copy", "index",
      "gelu", "embedding", "Embedding", "where", "masked")),
)

# phase 11: BASELINE config #4 (BASELINE.json configs[3];
# examples/rnn/lstm_bucketing.py): 2 LSTM layers of 200 over an embedding
# of 200, PTB's 10 000-word vocabulary (bench.py:297 `_LSTM_CFG`), batch
# 32, buckets 10-60, SGD lr 0.01 wd 1e-5 rescale 1/32, Xavier(in, 2.34),
# Perplexity(0); the example's synthetic power-law corpus (2000 sentences
# of 8-59 tokens, :31-40) stands in for PTB: the only cut
LSTM_CFG = dict(vocab=10000, embed=200, hidden=200, layers=2, batch=32,
                buckets=(10, 20, 30, 40, 50, 60), sentences=2000)
LSTM_OPT = {"learning_rate": 0.01, "momentum": 0.0, "wd": 1e-5,
            "rescale_grad": 1.0 / 32}
LSTM_PARITY_KEYS = (60, 20, 40, 20, 60, 10)   # 11a: a batch of each, in turn
LSTM_PARITY_MOMENTUM = 0.9    # 11a: the shared momenta are held too
LSTM_FIXED = dict(seq=35, warm=4, timed=20)   # bench.py's lane (:290-375)
LSTM_FIXED_OPT = {"learning_rate": 0.1, "momentum": 0.9,
                  "rescale_grad": 1.0 / 32}
# 11d: device kernels of one bucket-60 step by class (first match)
LSTM_CLASSES = (
    ("GEMM (the gates' FCs, the 10k-way head)",
     ("gemm", "sgemm", "xmma", "cutlass", "nvjet", "gemv", "splitK")),
    ("softmax (the head)", ("softmax", "SoftMax")),
    ("the update (multi-tensor SGD)", ("multi_tensor", "foreach")),
    ("reductions (bias gradients, sums, perplexity)", ("reduce_kernel",)),
    ("elementwise (gates, stack, slices, one-hot, casts, copies)",
     ("elementwise", "vectorized", "unrolled", "fill", "copy", "index",
      "embedding", "Embedding", "where", "cat", "Cat", "gather",
      "scatter")),
)

# phase 12: BASELINE config #2 (BASELINE.json configs[1]; examples/
# image_classification/train_imagenet.py with symbols/resnet.py): the
# pre-activation ResNet-50 v2 (bn_data with fix_gamma), 3x224x224, 1000
# classes, fed by ImageRecordIter(resize=256, rand_crop, rand_mirror,
# shuffle, the example's mean_r/g/b) through the h2d ring, fp32, batch
# 128, SGD lr 0.1 momentum 0.9 wd 1e-4 rescale 1/128, Xavier(gaussian,
# in, 2), acc + TopKAccuracy(5), Speedometer(128, 20), kvstore "device"
# (train_imagenet.py:60-113).  The corpus is synthetic (no ImageNet .rec
# is in the repository): 1024 images at 256 x 320 (short side = resize),
# labels i % 1000, blurred noise (tools/bench_io.py `build_corpus`) as
# JPEG (PIL, quality 95) where a codec imports, else PPM
IMAGENET_CORPUS = dict(n=1024, h=256, w=320)
IMAGENET_LAYERS = 50
IMAGENET_RESIZE = 256
IMAGENET_MEAN = dict(mean_r=123.68, mean_g=116.78, mean_b=103.94)
IMAGENET_STD = dict(std_r=58.4, std_g=57.1, std_b=57.4)   # 12a only
IMAGENET_OPT = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}
IMAGENET_BATCH = 128
IMAGENET_PARITY = (4, 2)        # 12b: (batch, steps), float64
IMAGENET_CHECK = (32, 2)        # 12a: (batch, batches) held bit for bit


def lstm_init(mx):
    """The example's initializer."""
    return mx.initializer.Xavier(factor_type="in", magnitude=2.34)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def within(got, ref, rtol, atol_scale):
    """max |got - ref| and whether |got - ref| <= rtol*|ref| +
    atol_scale*max|ref| everywhere (compared in got's dtype)."""
    diff = (got.float() - ref.float()).abs()
    bound = rtol * ref.float().abs() + atol_scale * ref.float().abs().max()
    return diff.max().item(), bool((diff <= bound).all())


# the plain attention's launches timed in phase 3b: 34-58 ms each at the
# long contexts (20 launches of it took ~14 s of the phase)
PLAIN_ITERS = 5


def time_ms(fn, flush, iters=20):
    """Median time of fn() over `iters` launches, each timed with its own
    CUDA events after the L2 cache is overwritten.  The median, not the
    mean: a launch the host delays (a host whose cores other work shares)
    leaves the card idle inside its events, and one such delay can double
    a mean."""
    for _ in range(3):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, reps=10, flush=None, names=None, tries=3, per_call=None):
    """Mean device time per call of fn() under torch.profiler: the sum of
    the durations of the kernels it launches, without the host time
    between launches that CUDA events around a small call also count.
    flush: a buffer overwritten before each call (its kernel is not
    counted: give `names`, the substrings of the kernels that are).
    per_call: {substring of a kernel's name: its launches in one call},
    where the caller knows them; the time is then each kernel's mean
    duration times its launches a call (`per_call_ms`).  The profiler
    drops events: a session that recorded none (seen once in ~270
    sessions on an H100, right after the same call ran and was checked),
    or, without `per_call`, not whole calls (each kernel a multiple of
    reps; seen in phase 3 on an H100, K1's cuda_core route at float16
    (128, 4096, 4096) read 0.0195 ms, a tenth of its 0.1956 ms: one call
    of ten recorded), or, with it, no launch of one of its kernels, is run
    again, up to `tries` sessions; when none of them serves (seen once,
    in phase 3 on an H100), fn() is timed with CUDA events instead
    (`time_ms`: host gaps between its launches included)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if flush is not None:
                    flush.zero_()
                fn()
            torch.cuda.synchronize()
        seen = collections.defaultdict(list)
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA and (
                    names is None or any(n in e.name for n in names)):
                seen[e.name].append(e.time_range.end - e.time_range.start)
        if per_call is not None:
            ms = per_call_ms(seen, per_call)
            if ms is not None:
                if sum(map(len, seen.values())) != reps * sum(
                        per_call.values()):
                    print(f"device_ms: a session recorded "
                          f"{ {n: len(d) for n, d in seen.items()} } for "
                          f"{reps} calls of {per_call}; each kernel's mean "
                          f"taken", flush=True)
                return ms
        elif seen and all(len(d) % reps == 0 for d in seen.values()):
            return sum(map(sum, seen.values())) / reps / 1e3
        if seen:
            print(f"device_ms: a session recorded "
                  f"{ {n: len(d) for n, d in seen.items()} } for {reps} "
                  f"calls (per call {per_call}); profiled again", flush=True)
    print(f"device_ms: no session of {tries} served; timed with CUDA events "
          "instead", flush=True)
    return time_ms(fn, flush if flush is not None else
                   torch.empty(1, device="cuda"))


def per_call_ms(seen, per_call):
    """One call's device time in ms from the kernels a session recorded
    (`seen`: {kernel name: [durations in us]}): the sum over `per_call`'s
    kernels ({substring: launches a call}) of launches times their mean
    duration; None when one of them has no recorded launch or a kernel
    outside them was recorded."""
    got = collections.defaultdict(list)
    for name, durations in seen.items():
        got[next((k for k in per_call if k in name), name)] += durations
    want = {k for k, v in per_call.items() if v}
    if set(got) != want:
        return None
    return sum(per_call[k] * statistics.fmean(got[k]) for k in want) / 1e3


def k1_per_call(x, w, route):
    """The kernels one K1 call launches under `route`'s plan (csrc/
    fc_relu.cu `launch`): fc_relu_tc or fc_relu_kernel, split_tf32 before
    fp32's tensor_core tile, splitk_epilogue after a split K."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import launch_plan
    plan = launch_plan(x, w, route)
    tc = plan["route"] == "tensor_core"
    return {"fc_relu_tc" if tc else "fc_relu_kernel": 1,
            "split_tf32": int(tc and x.dtype == F32),
            "splitk_epilogue": int(plan["splits"] > 1)}


def bound(m, k, n, dtype):
    """(least ms the card needs for relu(x @ w.T + b), "bytes" or
    "operations"): each input read once and the output written once at
    the HBM rate, against 2*M*N*K operations at the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_bytes = (m * k + n * k + n + m * n) * item / HBM_BYTES_S * 1e3
    t_ops = 2 * m * n * k / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_case(x, w, b, card, flush):
    """One K1 shape: parity of the library's route and of each route that
    takes the shape; the event and device times of each route, the plain
    version's and the library call's.  Returns them, the library's route
    and its error."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import ROUTES, \
        fc_relu, fc_relu_ref, launch_plan
    (m, k), n, dtype = x.shape, w.shape[0], x.dtype
    rtol, atol = TOL[dtype]
    chosen = launch_plan(x, w)["route"]
    routes = [r for r in ROUTES if launch_plan(x, w, r) is not None]
    ref = fc_relu_ref(x, w, b)
    errs = {}
    for route in [None] + routes:
        before = fc_relu.launches
        got = fc_relu(x, w, b, route)
        torch.cuda.synchronize()
        check(fc_relu.launches == before + 1,
              f"fc_relu launch counter did not move at {(m, k, n)}")
        check(got.dtype == dtype and got.shape == (m, n),
              f"fc_relu output {got.dtype} {tuple(got.shape)}")
        err, ok = within(got, ref, rtol, atol)
        check(ok, f"fc_relu ({route or chosen}) disagrees with its plain "
                  f"version at {(m, k, n)} {dtype}: max abs err {err:.3e}")
        errs[route or "chosen"] = err
    name = f"{str(dtype)[6:]:8s} M={m:<3d} K={k:<6d} N={n:<5d}"
    print(f"K1 parity {name} route={chosen} max_abs_err={errs['chosen']:.3e}"
          f" ({', '.join(f'{r} {errs[r]:.3e}' for r in routes)}; rtol "
          f"{rtol:g}, atol {atol:g}*max|plain|) ok")
    t_bound, bound_by = bound(m, k, n, dtype)
    t = {"route": chosen, "max_abs_err": errs["chosen"],
         "plain_ms": time_ms(lambda: fc_relu_ref(x, w, b), flush),
         "library_ms": time_ms(
             lambda: torch.relu(torch.addmm(b, x, w.T)), flush),
         "bound_ms": t_bound, "bound_by": bound_by}
    for route in routes:
        call = lambda: fc_relu(x, w, b, route)
        t[f"{route}_ms"] = time_ms(call, flush)
        kernels = k1_per_call(x, w, route)
        dev = device_ms(call, flush=flush, names=K1_KERNELS,
                        per_call=kernels)
        for _ in range(2):
            if dev >= t_bound:
                break
            # below the card's bound no launch can be: the profile lost
            # the route's main kernel (0.0039 ms against a 0.0200 ms
            # bound once, fp32 (1, 4096, 4096) tensor_core)
            print(f"K1 {name} {route}: profiled {dev:.4f} ms, below the "
                  f"bound {t_bound:.4f} ms; profiled again")
            dev = device_ms(call, flush=flush, names=K1_KERNELS,
                            per_call=kernels)
        t[f"{route}_device_ms"] = dev if dev >= t_bound else \
            t[f"{route}_ms"]
    t["ms"] = t[f"{chosen}_ms"]
    t["device_ms"] = t[f"{chosen}_device_ms"]
    print(f"K1 time   {name} route={chosen} kernel_ms={t['ms']:.4f} "
          f"device_ms={t['device_ms']:.4f} "
          + "".join(f"{r}_ms={t[f'{r}_ms']:.4f} "
                    f"{r}_device_ms={t[f'{r}_device_ms']:.4f} "
                    for r in routes)
          + f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']:.4f} "
          f"bound_ms={t_bound:.4f} ({bound_by}) "
          f"{t_bound / t['device_ms']:.3f} of the bound by device time "
          f"[{card}]")
    return t


def route_gate(t, dtype, shape, routes):
    """K1's route rule, gated: where both routes take the shape, the one
    the library takes spends at most K1_ROUTE_GATE's factor times the
    other's profiler device time, plus its slack.  Returns the line that
    the run prints for the shape."""
    chosen = t["route"]
    others = [r for r in routes if r != chosen]
    if not others:
        return None
    factor, slack = K1_ROUTE_GATE
    mine, other = t[f"{chosen}_device_ms"], t[f"{others[0]}_device_ms"]
    line = (f"{str(dtype)[6:]} {shape} {chosen} {mine:.4f} ms vs "
            f"{others[0]} {other:.4f} ms ({mine / other:.3f}x)")
    check(mine <= factor * other + slack,
          f"K1 takes the slower route at {shape} {dtype}: {line}; the gate "
          f"is {factor:g}x the other's device time + {slack:g} ms")
    return line


def kernel_phase(card):
    """Phase 3; returns the JSON numbers of REP and REP_BF16 by dtype, and
    of the mlp's, phases 14 and 16's and AlexNet's fc6 (phase 17) shapes
    by (M, K, N, dtype)."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import ROUTES, \
        launch_plan
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    cases = [(m, k, n) for k, n in VGG_FC_SHAPES + (ALEX_FC6,)
             for m in K1_ROWS]
    cases.append((5, 784, 128))
    reps, gated = {}, []
    t0 = time.perf_counter()
    for dtype in (F32, BF16, F16):
        for m, k, n in cases:
            x = torch.randn(m, k, generator=gen, device=dev).to(dtype)
            w = (torch.randn(n, k, generator=gen, device=dev)
                 / math.sqrt(k)).to(dtype)
            b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dtype)
            t = k1_case(x, w, b, card, flush)
            gated.append(route_gate(t, dtype, (m, k, n), ROUTES))
            if k >= 4096 and n == 4096:
                # VGG-16's and AlexNet's fc6/fc7 keep the kTcMinRows rule
                check(t["route"] == ("tensor_core"
                                     if m >= K1_TC_MIN_ROWS[dtype]
                                     else "cuda_core"),
                      f"K1's route at {(m, k, n)} {dtype} is "
                      f"{t['route']}, not the kTcMinRows rule's")
            if (m, k, n, dtype) in (REP, REP_BF16):
                reps[dtype] = t
            if (m, k, n, dtype) in (ALEX_REP, ALEX_REP_BF16):
                reps[(m, k, n, dtype)] = t
            del x, w, b
    for m, k, n in MLP_K1 + tuple(shape for shape, _, _ in PATH_K1):
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(n, k, generator=gen, device=dev) / math.sqrt(k)
        b = 0.1 * torch.randn(n, generator=gen, device=dev)
        check((m, k, n) not in MLP_K1 or
              all(launch_plan(x, w, r) is not None for r in ROUTES),
              f"a K1 route does not take the mlp shape {(m, k, n)}")
        reps[(m, k, n, F32)] = k1_case(x, w, b, card, flush)
        gated.append(route_gate(reps[(m, k, n, F32)], F32, (m, k, n),
                                ROUTES))
    gated = [g for g in gated if g is not None]
    print(f"K1 routes: the route taken held to "
          f"{K1_ROUTE_GATE[0]:g}x the other's device time + "
          f"{K1_ROUTE_GATE[1]:g} ms at all {len(gated)} shapes both "
          f"routes take ok [{card}]")
    for line in gated:
        print(f"K1 route  {line}")
    k1_host_us(card, gen)
    print(f"phase 3: {time.perf_counter() - t0:.1f} s")
    del flush
    return reps


def k1_host_us(card, gen):
    """Host time per call of fc_relu at fc7 (4096 -> 4096), M = 32, by
    route and dtype, beside the library call's: where it exceeds the
    kernels' device time, a lone call's time is the host's."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import ROUTES, fc_relu
    for dtype in (F32, BF16):
        x = torch.randn(32, 4096, generator=gen, device="cuda").to(dtype)
        w = torch.randn(4096, 4096, generator=gen, device="cuda").to(dtype)
        b = torch.randn(4096, generator=gen, device="cuda").to(dtype)
        us = {r: host_us(lambda: fc_relu(x, w, b, r)) for r in ROUTES}
        lib = host_us(lambda: torch.relu(torch.addmm(b, x, w.T)))
        print(f"host: fc_relu {str(dtype)[6:]} M=32 K=4096 N=4096 "
              + ", ".join(f"{r} {us[r]:.1f}" for r in ROUTES)
              + f" us per call on the host; torch.relu(torch.addmm) "
              f"{lib:.1f} [{card}]")


def vgg_params(sym, rng):
    """He-scaled random weights for every argument but ``data``."""
    shapes, _, _ = sym.infer_shape(data=(1,) + IMAGE)
    params = {}
    for name, shape in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith("_bias"):
            params[name] = np.zeros(shape, np.float32)
        else:
            fan_in = int(np.prod(shape[1:]))
            params[name] = (rng.standard_normal(shape)
                            * math.sqrt(2.0 / fan_in)).astype(np.float32)
    return params


def profile_dispatch(model, card, bucket=32, reps=3, tries=3):
    """Device time by kernel over `reps` warm dispatches of one full
    bucket (torch.profiler), and the device's busy share of that window;
    a session that records no kernel is run again (see device_ms)."""
    from torch.profiler import ProfilerActivity, profile
    arrs = [np.zeros((bucket,) + IMAGE, np.float32)]
    model.run_bucket(arrs, bucket)
    model.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model.run_bucket(arrs, bucket)
            model.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, f"the profiler saw no device activity in {tries} sessions")
    by_name = {}
    busy = 0.0
    edge = -math.inf
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    total = sum(by_name.values())
    print(f"profile: bucket {bucket}, {reps} dispatches, "
          f"{wall_us / reps / 1e3:.2f} ms each on the host clock, device "
          f"busy {busy / wall_us:.3f} of the window [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile: {us / reps / 1e3:9.3f} ms/dispatch "
              f"{us / total:6.3f} {name[:100]}")
    k1 = sum(us for name, us in by_name.items()
             if any(k in name for k in K1_KERNELS))
    print(f"profile: K1 ({' + '.join(K1_KERNELS)}) "
          f"{k1 / reps / 1e3:.3f} ms/dispatch, {k1 / total:.3f} of device "
          "time")


def serve_phase(card, workdir):
    """Serve VGG-16 through ModelServer on gpu(0); returns the K1
    launches of the run (warm-up included)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu

    rng = np.random.RandomState(SEED)
    sym = mx.model_zoo.vgg_symbol(16, classes=CLASSES)
    part = mx.subgraph.partition_graph(sym, "TPU_PALLAS")
    fused = [n["op"] for n in json.loads(part.tojson())["nodes"]
             ].count("_sg_pallas_fc_relu")
    check(fused == 2, f"TPU_PALLAS fused {fused} FC+ReLU chains, want 2")
    t0 = time.perf_counter()
    params = vgg_params(sym, rng)
    print(f"serve: VGG-16 {sum(p.size for p in params.values())} "
          f"parameters from RandomState({SEED}) in "
          f"{time.perf_counter() - t0:.1f} s")
    load = [[rng.rand(rng.randint(1, 9), *IMAGE).astype(np.float32)
             for _ in range(REQUESTS_PER_CLIENT)] for _ in range(CLIENTS)]
    solo = [rng.rand(r, *IMAGE).astype(np.float32) for r in SOLO_ROWS]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "vgg")
        mx.save_checkpoint(prefix, 0, part, params, {})
        srv = mx.serving.ModelServer(max_queue_latency_ms=5.0, ctx=mx.gpu(0))
        fc_relu.launches = 0
        t0 = time.perf_counter()
        srv.load_model("vgg", prefix=prefix,
                       data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
        print(f"serve: load + warmup of {len(BUCKETS)} buckets "
              f"{time.perf_counter() - t0:.1f} s")

        def ask(x):
            return srv.predict("vgg", {"data": x},
                               timeout_ms=600_000)[0].asnumpy()

        answers = [[None] * REQUESTS_PER_CLIENT for _ in range(CLIENTS)]
        errors = []
        gate = threading.Barrier(CLIENTS + 1)

        def client(c):
            gate.wait()
            try:
                for i, x in enumerate(load[c]):
                    answers[c][i] = ask(x)
            except Exception as exc:   # reported below, fails the run
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(c,),
                                    name=f"chip-smoke-client-{c}")
                   for c in range(CLIENTS)]
        for th in threads:
            th.start()
        gate.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join(600)
        wall = time.perf_counter() - t0
        check(not errors, f"requests failed: {errors[:3]}")
        check(not any(th.is_alive() for th in threads), "a client hung")
        stats = srv.stats()["vgg"]
        solo_answers = [ask(x) for x in solo]
        solo_batches = srv.stats()["vgg"]["batches"] - stats["batches"]
        launches = fc_relu.launches
        profile_dispatch(srv.model("vgg"), card)
        srv.shutdown(drain=True)
    check(solo_batches == len(solo),
          f"{len(solo)} lone requests ran as {solo_batches} batches")
    batches = stats["batches"] + solo_batches
    expect = 2 * (len(BUCKETS) + batches)
    print(f"serve: {stats['batches']} batches for {CLIENTS * REQUESTS_PER_CLIENT}"
          f" requests, then {solo_batches} lone requests of "
          f"{', '.join(map(str, SOLO_ROWS))} rows (buckets "
          f"{', '.join(str(min(b for b in BUCKETS if b >= r)) for r in SOLO_ROWS)}"
          f"); K1 launches {launches}, expected 2 x ({len(BUCKETS)} warmup "
          f"+ {batches}) = {expect}")
    check(launches == expect, "K1 did not run twice per dispatched batch")

    # every answer against the unpartitioned graph (plain FC path)
    device = torch.device("cuda", 0)
    gfn, arg_nodes, _ = mx.sym.graph_eval_fn(sym, False)
    weights = {k: torch.from_numpy(v).to(device) for k, v in params.items()}
    worst = 0.0
    rtol, atol = SERVE_TOL
    pairs = [(x, got) for xs, gots in zip(load, answers)
             for x, got in zip(xs, gots)] + list(zip(solo, solo_answers))
    with torch.inference_mode():
        for x, got in pairs:
            feed = dict(weights, data=torch.from_numpy(x).to(device))
            ref = gfn([feed[n.name] for n in arg_nodes], [])[0][0]
            check(got.shape == (x.shape[0], CLASSES)
                  and np.isfinite(got).all(),
                  f"answer shape {got.shape} or non-finite values")
            err, ok = within(torch.from_numpy(got), ref.cpu(), rtol, atol)
            worst = max(worst, err)
            check(ok, f"served answer disagrees with the unpartitioned "
                      f"graph (max abs err {err:.3e})")
    rows = sum(len(x) for xs in load for x in xs)
    print(f"serve: {len(pairs)} answers match the unpartitioned graph, "
          f"max_abs_err {worst:.3e} (rtol {rtol:g}, atol {atol:g}*max|ref|)")
    print(f"serve: load of {CLIENTS} closed-loop clients: {rows} images in "
          f"{stats['responses']} requests over {wall:.3f} s = "
          f"{rows / wall:.1f} images/s, p50 {stats['p50_ms']:.1f} ms, "
          f"p99 {stats['p99_ms']:.1f} ms, batch occupancy "
          f"{stats['batch_occupancy']:.3f} [{card}]")
    return launches


def attn_ops(b, h, tq, tk, d, causal, q_off, k_off):
    """4*D operations for every (query, key) pair the causal mask leaves
    (these offsets' pairs, counted exactly)."""
    if causal:
        seen = np.clip(q_off + np.arange(tq) - k_off + 1, 0, tk)
        pairs = int(seen.sum())
    else:
        pairs = tq * tk
    return 4 * b * h * pairs * d


def attn_bound(b, h, tq, tk, d, dtype, causal, q_off, k_off):
    """(least ms for one partial-attention call, "bytes" or "operations"):
    q, k, v read and o, m, l written once at the HBM rate, against
    `attn_ops` at the type's peak."""
    item = torch.tensor([], dtype=dtype).element_size()
    t_ops = attn_ops(b, h, tq, tk, d, causal, q_off, k_off) / \
        PEAK_FLOPS[dtype] * 1e3
    t_bytes = ((2 * b * tq * h * d + 2 * b * tk * h * d) * item
               + 2 * b * h * tq * 4) / HBM_BYTES_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attn_inputs(shape, dtype, seed, packed=False):
    """q, k, v of `shape` from a seed; packed: views of one (B, T, 3, H,
    D) tensor, as a fused QKV projection leaves them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if packed:
        b, t, h, d = shape
        qkv = torch.randn(b, t, 3, h, d, generator=gen,
                          device="cuda").to(dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    return tuple(torch.randn(*shape, generator=gen, device="cuda").to(dtype)
                 for _ in range(3))


def set_budget(budget):
    """Set MXNET_FLASH_VMEM_MB (None: unset); returns the value before."""
    old = os.environ.pop("MXNET_FLASH_VMEM_MB", None)
    if budget is not None:
        os.environ["MXNET_FLASH_VMEM_MB"] = budget
    return old


def sdpa_equivalent(causal, offs, t):
    """(is_causal of the SDPA call that computes the same normalised
    attention as this partial call, or None, and the reason when None)."""
    q_off, k_off = offs
    if not causal or q_off - k_off >= t - 1:
        return False, None          # every row sees every key
    if q_off == k_off:
        return True, None           # the diagonal where SDPA puts it
    if k_off >= q_off + t:
        return None, ("no row sees a key: SDPA computes no such call (its "
                      "softmax over no key is not the contract's m = -1e30, "
                      "l = 0, o = 0)")
    return None, "a shifted diagonal: SDPA's is_causal has no offset"


def host_us(fn, calls=200):
    """Host time per call of fn(), in microseconds: the enqueue, which is
    a small call's time when the device keeps up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def host_us_per_call(card):
    """Host time per call of flash_attention_partial at (2, 2048, 8, 64)
    bf16 causal (the enqueue, which is the call's time at this size), and
    of the two fills its m and l took before they were torch.empty."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    q, k, v = attn_inputs((2, 2048, 8, 64), BF16, 99)

    def fills():
        torch.full((2, 8, 2048), -1e30, dtype=torch.float32, device="cuda")
        torch.zeros((2, 8, 2048), dtype=torch.float32, device="cuda")

    call = host_us(lambda: fa.flash_attention_partial(q, k, v, 0, 0, True))
    before = host_us(fills)
    print(f"host: flash_attention_partial bf16 2x2048x8x64 causal "
          f"{call:.1f} us per call on the host (m, l by torch.empty); the "
          f"two fills m and l took before (torch.full + torch.zeros of "
          f"(B, H, Tq)) {before:.1f} us per call [{card}]")


def attn_kernel_phase(card, flush):
    """Phase 3b: K2 and K3 against `_partial_ref`; returns the JSON
    numbers of REP_K2, REP_K3, REP_K2_F32 and REP_K3_F32."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    reps = {}
    for seed, (label, shape, dtype, causal, offs, budget, route) in \
            enumerate(ATTN_CASES):
        b, t, h, d = shape
        q, k, v = attn_inputs(shape, dtype, seed, label == "packed qkv")
        old = set_budget(budget)
        try:
            check(fa._route(t, d, dtype) == route,
                  f"{label} {shape} takes route {fa._route(t, d, dtype)}")
            wrapper = fa.flash_fwd if route == "whole" else \
                fa.flash_fwd_stream
            other = fa.flash_fwd_stream if route == "whole" else fa.flash_fwd
            counts = (wrapper.launches, other.launches)
            o, m, l = fa.flash_attention_partial(q, k, v, *offs, causal)
            torch.cuda.synchronize()
            check((wrapper.launches, other.launches)
                  == (counts[0] + 1, counts[1]),
                  f"{label} {shape}: {wrapper.__name__} did not launch once")
            run = lambda: fa.flash_attention_partial(q, k, v, *offs, causal)
            ms = time_ms(run, flush)
            dev_ms = device_ms(run)
        finally:
            set_budget(old)
        name = (f"{route:6s} {label:13s} {str(dtype)[6:]:8s} "
                f"{'x'.join(map(str, shape)):14s} causal={causal!s:5s} "
                f"off={offs}")
        check(o.dtype == dtype and o.shape == shape
              and m.shape == l.shape == (b, h, t), f"{name}: output shapes")
        if offs[1] >= offs[0] + t and causal:
            # every key after every query: the kernel's contract
            ok = bool((o == 0).all() and (l == 0).all()
                      and (m == -1e30).all())
            print(f"K2/K3 parity {name} m=-1e30, l=0, o=0 (the contract "
                  f"for rows that see no key) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name}: rows with no visible key break the contract")
            err = 0.0
        else:
            rtol, atol = ATTN_TOL[dtype]
            plain = fa._ref_bthd(q, k, v, *offs, causal, 256)
            errs, oks = zip(*(within(g, w, rtol, atol)
                              for g, w in zip((o, m, l), plain)))
            err = errs[0]
            print(f"K2/K3 parity {name} max_abs_err o={errs[0]:.3e} "
                  f"m={errs[1]:.3e} l={errs[2]:.3e} (rtol {rtol:g}, atol "
                  f"{atol:g}*max|plain|) {'ok' if all(oks) else 'FAIL'}")
            check(all(oks), f"{name}: kernel disagrees with _partial_ref")
        t_bound, bound_by = attn_bound(b, h, t, t, d, dtype, causal, *offs)
        times = {"ms": ms, "bound_ms": t_bound, "bound_by": bound_by,
                 "max_abs_err": err, "library_ms": None,
                 "plain_ms": time_ms(lambda: fa._ref_bthd(
                     q, k, v, *offs, causal, 256), flush, PLAIN_ITERS)}
        lib_causal, why = sdpa_equivalent(causal, offs, t)
        if lib_causal is None:
            print(f"K2/K3 vs SDPA {name} n/a: {why}")
        else:
            qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            lib = lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=lib_causal)
            times["library_ms"] = time_ms(lib, flush)
            out = o / l.transpose(1, 2)[..., None].to(o.dtype)
            rtol, atol = SDPA_TOL[dtype]
            serr, sok = within(out, lib().transpose(1, 2), rtol, atol)
            print(f"K2/K3 vs SDPA {name} (kernel + division, normalised; "
                  f"SDPA is_causal={lib_causal}) max_abs_err={serr:.3e} "
                  f"(rtol {rtol:g}, atol {atol:g}*max|SDPA|) "
                  f"{'ok' if sok else 'FAIL'}")
            check(sok, f"{name}: the port's attention disagrees with SDPA")
        lib_ms = ("n/a" if times["library_ms"] is None
                  else f"{times['library_ms']:.4f}")
        tflops = attn_ops(b, h, t, t, d, causal, *offs) / ms / 1e9
        print(f"K2/K3 time   {name} kernel_ms={ms:.4f} "
              f"plain_ms={times['plain_ms']:.4f} library_ms={lib_ms} "
              f"bound_ms={t_bound:.4f} ({bound_by}) {tflops:.1f} TFLOP/s, "
              f"{t_bound / ms:.3f} of the bound; device_ms={dev_ms:.4f} "
              f"(profiler) [{card}]")
        key = (label, shape, dtype, causal, offs, budget)
        if key in (REP_K2, REP_K3, REP_K2_F32, REP_K3_F32):
            reps[key] = dict(times, shape=f"{str(dtype)[6:]} "
                             f"B,T,H,D={b},{t},{h},{d} causal={causal}")
        del q, k, v, o, m, l
    host_us_per_call(card)
    return reps


def plain_attention(q, k, v, causal):
    """fp32 attention with the (T, T) scores, the autograd reference."""
    d = q.shape[-1]
    qh, kh, vh = (x.float().transpose(1, 2) for x in (q, k, v))
    s = qh @ kh.transpose(-1, -2) / math.sqrt(d)
    if causal:
        t = s.shape[-1]
        mask = torch.ones(t, t, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    return (torch.softmax(s, dim=-1) @ vh).transpose(1, 2)


def path_case(shape, dtype, seed):
    """flash_attention forward and backward against plain_attention in
    fp32 on the same inputs; returns (out, q, k, v) for the ring check."""
    from incubator_mxnet_tpu_torch.ops.flash_attention import flash_attention
    q, k, v = (x.requires_grad_() for x in attn_inputs(shape, dtype, seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 100)
    tgt = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    out = flash_attention(q, k, v, True, PATH_BLOCK, PATH_BLOCK)
    ((out.float() - tgt.float()) ** 2).sum().backward()
    torch.cuda.synchronize()
    refs = [x.detach().float().requires_grad_() for x in (q, k, v)]
    ref = plain_attention(*refs, True)
    ((ref - tgt.float()) ** 2).sum().backward()
    rtol, atol = PATH_TOL[dtype]
    results = [(name, *within(g, w, rtol, atol), w.abs().max().item())
               for name, g, w in (("out", out, ref),
                                  ("dq", q.grad, refs[0].grad),
                                  ("dk", k.grad, refs[1].grad),
                                  ("dv", v.grad, refs[2].grad))]
    for name, err, ok, top in results:
        print(f"path  {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):14s} "
              f"{name:3s} max_abs_err={err:.3e} max|ref|={top:.3e} vs fp32 "
              f"T x T autograd (rtol {rtol:g}, atol {atol:g}*max|ref|) "
              f"{'ok' if ok else 'FAIL'}")
    check(all(ok for _, _, ok, _ in results),
          f"flash_attention {shape} {dtype} disagrees with plain attention")
    del ref, refs
    return out.detach(), q.detach(), k.detach(), v.detach()


def path_times(shape, dtype, card, flush, seed):
    """Forward and forward+backward ms of flash_attention and of SDPA."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.ops.flash_attention import flash_attention
    q, k, v = (x.requires_grad_() for x in attn_inputs(shape, dtype, seed))
    qh, kh, vh = (x.detach().transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    g = torch.ones(shape, dtype=dtype, device="cuda")
    gh = g.transpose(1, 2).contiguous()

    def port_fwd():
        with torch.no_grad():
            flash_attention(q, k, v, True, PATH_BLOCK, PATH_BLOCK)

    def port_both():
        flash_attention(q, k, v, True, PATH_BLOCK, PATH_BLOCK).backward(g)

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)

    def sdpa_both():
        F.scaled_dot_product_attention(qh, kh, vh,
                                       is_causal=True).backward(gh)

    t = {name: time_ms(fn, flush, iters=5) for name, fn in
         (("fwd", port_fwd), ("fwd+bwd", port_both), ("sdpa fwd", sdpa_fwd),
          ("sdpa fwd+bwd", sdpa_both))}
    budget = os.environ.get("MXNET_FLASH_VMEM_MB", "default")
    print(f"path  {str(dtype)[6:]:8s} {'x'.join(map(str, shape)):14s} "
          f"MXNET_FLASH_VMEM_MB={budget} "
          f"causal flash_attention forward {t['fwd']:.3f} ms, forward+"
          f"backward {t['fwd+bwd']:.3f} ms; SDPA forward "
          f"{t['sdpa fwd']:.3f} ms, forward+backward "
          f"{t['sdpa fwd+bwd']:.3f} ms [{card}]")


def attention_path_phase(card, flush):
    """Phase 5; returns the K2 and K3 launches of the path's run."""
    from incubator_mxnet_tpu_torch.ops import flash_attention as fa
    from incubator_mxnet_tpu_torch.parallel import ring_attention
    import torch.distributed as dist
    check(not (dist.is_available() and dist.is_initialized()),
          "a process group is initialised")
    old = set_budget(None)
    try:
        fa.flash_fwd.launches = 0
        fa.flash_fwd_stream.launches = 0
        out, q, k, v = path_case((2, 8192, 8, 64), BF16, 0)
        check((fa.flash_fwd.launches, fa.flash_fwd_stream.launches)
              == (1, 0), "flash_attention forward+backward launched "
              f"K2 {fa.flash_fwd.launches}, K3 {fa.flash_fwd_stream.launches}"
              " times, want 1, 0")
        ring = ring_attention(q, k, v, causal=True, use_pallas=True)
        torch.cuda.synchronize()
        check(fa.flash_fwd.launches == 2, "ring_attention(use_pallas=True) "
              "did not launch K2 once")
        rtol, atol = ATTN_TOL[BF16]
        err, ok = within(ring, out, rtol, atol)
        print(f"path  ring_attention(use_pallas=True), no process group: "
              f"max_abs_err={err:.3e} vs flash_attention (rtol {rtol:g}, "
              f"atol {atol:g}*max|flash|) {'ok' if ok else 'FAIL'}")
        check(ok, "ring_attention disagrees with flash_attention")
        del out, q, k, v, ring
        torch.cuda.empty_cache()
        path_case((2, 8192, 8, 64), F32, 6)
        check(fa.flash_fwd.launches == 3, "fp32 flash_attention did not "
              "launch K2 once")
        torch.cuda.empty_cache()
        path_case((1, 32768, 1, 64), F32, 1)
        torch.cuda.empty_cache()
        set_budget("4")
        path_case((1, 32768, 1, 64), BF16, 4)
        set_budget(None)
        launches = (fa.flash_fwd.launches, fa.flash_fwd_stream.launches)
        check(launches == (3, 2), f"the path launched K2, K3 {launches} "
              "times, want 3, 2")
        print(f"path  launches: K2 {launches[0]} (flash_attention bf16 + "
              f"ring + flash_attention fp32), K3 {launches[1]} (the 32768 "
              "envelope, fp32 and bf16 under MXNET_FLASH_VMEM_MB=4)")
        torch.cuda.empty_cache()
        path_times((2, 8192, 8, 64), BF16, card, flush, 2)
        path_times((2, 8192, 8, 64), F32, card, flush, 7)
        path_times((1, 32768, 1, 64), F32, card, flush, 3)
        set_budget("4")
        path_times((1, 32768, 1, 64), BF16, card, flush, 5)
    finally:
        set_budget(old)
    return launches


def mlp_symbol(mx, prefix=""):
    """train_mnist's ``mlp`` (examples/image_classification/
    train_mnist.py get_mlp); `prefix` before every layer's name."""
    s = mx.sym
    data = s.Flatten(s.Variable("data"))
    fc1 = s.FullyConnected(data, name=prefix + "fc1", num_hidden=128)
    act1 = s.Activation(fc1, name=prefix + "relu1", act_type="relu")
    fc2 = s.FullyConnected(act1, name=prefix + "fc2", num_hidden=64)
    act2 = s.Activation(fc2, name=prefix + "relu2", act_type="relu")
    fc3 = s.FullyConnected(act2, name=prefix + "fc3", num_hidden=10)
    return s.SoftmaxOutput(fc3, name="softmax")


def lenet_symbol(mx):
    """train_mnist's ``lenet`` (get_lenet)."""
    s = mx.sym
    x = s.Variable("data")
    for nf in (20, 50):
        x = s.Convolution(x, kernel=(5, 5), num_filter=nf)
        x = s.Activation(x, act_type="tanh")
        x = s.Pooling(x, pool_type="max", kernel=(2, 2), stride=(2, 2))
    x = s.Activation(s.FullyConnected(s.Flatten(x), num_hidden=500),
                     act_type="tanh")
    return s.SoftmaxOutput(s.FullyConnected(x, num_hidden=10),
                           name="softmax")


def mnist_iters(mx):
    """train_mnist's synthetic stand-in: 3584 training images (shuffled
    by np.random, seeded here) and 512 validation images."""
    x, y = mx.test_utils.get_mnist_like(TRAIN_IMAGES)
    np.random.seed(SEED)
    return (mx.io.NDArrayIter(x[:TRAIN_SPLIT], y[:TRAIN_SPLIT], TRAIN_BATCH,
                              shuffle=True),
            mx.io.NDArrayIter(x[TRAIN_SPLIT:], y[TRAIN_SPLIT:], TRAIN_BATCH))


def cross_entropy(probs, labels):
    """Mean -log p[label] of one batch's softmax outputs."""
    p = probs.asnumpy()
    return float(-np.log(p[np.arange(len(p)),
                           labels.asnumpy().astype(int)]).mean())


def first_steps(mx, sym, ctx, batches, teacher=None):
    """PARITY_STEPS Module steps (forward_backward, update) on `ctx` from
    Xavier parameters under mx.random.seed(SEED): the loss of each step
    and the states, ({name: parameter}, {name: momentum}), before the
    first step and after each.  With `teacher` (another run's states),
    step k starts from the teacher's state before it."""
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (TRAIN_BATCH, 1, 28, 28))],
             [("softmax_label", (TRAIN_BATCH,))])
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": TRAIN_LR,
                                         "momentum": TRAIN_MOMENTUM})
    names = mod._exec_group.param_names
    losses = []
    states = [({n: v.asnumpy() for n, v in mod.get_params()[0].items()}, {})]
    for k, batch in enumerate(batches):
        if teacher is not None and k:
            params, moms = teacher[k]
            mod.set_params(params, {})
            for i, n in enumerate(names):
                mod._updater.states[i]._set_data(moms[n])
        mod.forward_backward(batch)
        mod.update()
        losses.append(cross_entropy(mod.get_outputs()[0], batch.label[0]))
        states.append(({n: v.asnumpy()
                        for n, v in mod.get_params()[0].items()},
                       {names[i]: m.asnumpy()
                        for i, m in mod._updater.states.items()}))
    return losses, states


def param_ratio(got, ref, skip=()):
    """The largest |got - ref| / (rtol |ref| + atol max|ref|) over every
    array of `ref` whose name does not start with one of `skip`
    (PARITY_TOL; at most 1 passes), and that array's name."""
    rtol, atol = PARITY_TOL
    return max(((float((np.abs(got[n] - c) / (
        rtol * np.abs(c) + atol * np.abs(c).max())).max()), n)
        for n, c in ref.items() if not n.startswith(skip)),
        default=(0.0, "none"))


def pool_routes(params, x, ctx):
    """Which element wins each window of lenet's two max-pool layers at
    these parameters and images, computed on `ctx` by the torch calls
    the port's Convolution, tanh and Pooling make."""
    import torch.nn.functional as F
    dev = ctx.torch_device
    p = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    h = torch.from_numpy(x).to(dev)
    routes = []
    for i in (0, 1):
        h = torch.tanh(F.conv2d(h, p[f"convolution_{i}_weight"],
                                p[f"convolution_{i}_bias"]))
        h, idx = F.max_pool2d(h, 2, 2, return_indices=True)
        routes.append(idx.cpu())
    return routes


def flipped(mx, cpu_params, gpu_params, x):
    """Max-pool windows whose winner differs between the CPU at
    `cpu_params` and the card at `gpu_params` on images `x`."""
    return sum(int((a != b).sum()) for a, b in zip(
        pool_routes(cpu_params, x, mx.cpu()),
        pool_routes(gpu_params, x, mx.gpu(0))))


def parity_case(mx, name, sym):
    """The first PARITY_STEPS steps on the card against the CPU, from the
    same initial parameters and batches: free running (the loss of every
    step within rtol, the parameters after the last within PARITY_TOL),
    then each card step from the CPU's state before it (parameters and
    momentum after it within PARITY_TOL).

    A max-pool window whose two largest inputs lie within fp32 rounding
    of each other may be won by one element on the CPU and by the other
    on the card; its gradient then reaches the convolutions below through
    another pixel, a difference of a pixel's whole share of the gradient
    and not of rounding.  lenet's windows are recomputed on both devices:
    at a step where a window flipped, the convolutions' parameters and
    momentum are printed and not held, and the free-running parameters
    are held only when no window flipped along the way.  Every other
    array of every step is held."""
    train, _ = mnist_iters(mx)
    batches = [next(train) for _ in range(PARITY_STEPS)]
    xs = [b.data[0].asnumpy() for b in batches]
    pooled = name == "lenet"
    cpu_loss, cpu = first_steps(mx, sym, mx.cpu(), batches)
    gpu_loss, gpu = first_steps(mx, sym, mx.gpu(0), batches)
    _, forced = first_steps(mx, sym, mx.gpu(0), batches, teacher=cpu)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    free_flips = sum(flipped(mx, c[0], g[0], x) for c, g, x in
                     zip(cpu, gpu, xs)) if pooled else 0
    free, free_at = param_ratio(gpu[-1][0], cpu[-1][0])
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, x in enumerate(xs):
        n = flipped(mx, cpu[k][0], cpu[k][0], x) if pooled else 0
        skip = ("convolution",) if n else ()
        after, ref = forced[k + 1], cpu[k + 1]
        held = max(held, param_ratio(after[0], ref[0], skip),
                   param_ratio(after[1], ref[1], skip))
        if n:
            flips.append(f"step {k + 1}: {n}")
            excused = max(excused, param_ratio(after[0], ref[0]),
                          param_ratio(after[1], ref[1]))
    ok = loss_err <= PARITY_TOL[0] and held[0] <= 1 and \
        (free <= 1 or free_flips > 0)
    free_note = f"; not held: {free_flips} max-pool windows flipped on " \
        "the way" if free_flips else ""
    print(f"train {name:5s} first {PARITY_STEPS} steps, card vs CPU: loss "
          f"{' '.join(f'{v:.4f}' for v in gpu_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); parameters after "
          f"step {PARITY_STEPS} at {free:.3f} of the tolerance (worst "
          f"{free_at}{free_note}); each step from the CPU's state: "
          f"parameters and momentum at {held[0]:.3f} of it (worst "
          f"{held[1]}) (rtol {PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}"
          f"*max|array|) {'ok' if ok else 'FAIL'}")
    if pooled:
        note = f"; at those steps the convolutions at {excused[0]:.3f} " \
            f"of the tolerance (worst {excused[1]}), not held" \
            if flips else ""
        print(f"train {name:5s} max-pool windows flipped between the CPU "
              f"and the card from the CPU's state: "
              f"{', '.join(flips) or 'none'}{note}")
    check(ok, f"{name}: the card's first steps disagree with the CPU's")


def profile_step(mx, mod, batch, card):
    """Device time by kernel of one warm mlp step (fit_step: the fused
    step's forward, backward, update and metric); returns K1's share.
    A session that recorded no K1 kernel, though the step launches two
    (one session recorded only the last 17 of a step's ~50 kernels), is
    run again, up to 3 sessions."""
    from torch.profiler import ProfilerActivity, profile
    metric = mx.metric.create("acc")
    mod.fit_step(batch, metric)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mod.fit_step(batch, metric)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if any(k in name for _, _, name in spans for k in K1_KERNELS):
            break
    check(spans, "the profiler saw no device activity in a training step")
    by_name, busy, edge = {}, 0.0, -math.inf
    for start, end, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    total = sum(by_name.values())
    k1 = sum(us for name, us in by_name.items()
             if any(k in name for k in K1_KERNELS))
    print(f"train mlp profile: one step {wall_us / 1e3:.3f} ms on the host "
          f"clock, {len(spans)} kernels, device time {total / 1e3:.3f} ms, "
          f"busy {busy / wall_us:.3f} of the window; K1 {k1 / 1e3:.4f} ms "
          f"= {k1 / total:.3f} of device time [{card}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"train mlp profile: {us / 1e3:8.4f} ms {us / total:6.3f} "
              f"{name[:90]}")
    return k1 / total


def fit_case(mx, name, sym, card):
    """Module.fit on the card with train_mnist's defaults; returns the
    module, K1's launches and the step numbers."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    train, val = mnist_iters(mx)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    ticks = []
    mx.random.seed(SEED)
    fc_relu.launches = 0
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": TRAIN_MOMENTUM},
            initializer=mx.initializer.Xavier(), num_epoch=TRAIN_EPOCHS,
            batch_end_callback=[
                lambda p: ticks.append((p.nbatch, time.perf_counter())),
                mx.callback.Speedometer(TRAIN_BATCH, 50)])
    wall = time.perf_counter() - t0
    launches = fc_relu.launches
    steps = TRAIN_EPOCHS * -(-TRAIN_SPLIT // TRAIN_BATCH)
    evals = TRAIN_EPOCHS * -(-(TRAIN_IMAGES - TRAIN_SPLIT) // TRAIN_BATCH)
    expect = 2 * (steps + evals) if name == "mlp" else 0
    print(f"train {name:5s} K1 launches {launches}, expected "
          f"{'2 x' if expect else '0 x'} ({steps} train + {evals} eval "
          f"forwards) = {expect}")
    check(len(ticks) == steps and launches == expect,
          f"{name}: {len(ticks)} steps, K1 launched {launches} times, want "
          f"{steps} steps and {expect} launches")
    acc = mod.score(val, "acc")[0][1]
    check(fc_relu.launches - launches == expect // TRAIN_EPOCHS
          - 2 * (steps // TRAIN_EPOCHS) * bool(expect),
          f"{name}: score's forwards did not run K1 twice each")
    step_ms = [(t1 - t0_) * 1e3 for (_, t0_), (n1, t1) in
               zip(ticks, ticks[1:]) if n1 > 0]
    med = statistics.median(step_ms)
    print(f"train {name:5s} {TRAIN_EPOCHS} epochs of {steps // TRAIN_EPOCHS} "
          f"steps in {wall:.2f} s (eval included); step median {med:.3f} ms "
          f"(p10 {np.percentile(step_ms, 10):.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}) = {TRAIN_BATCH / med * 1e3:.0f}"
          f" samples/s; validation accuracy {acc:.4f} (> 0.95) "
          f"{'ok' if acc > 0.95 else 'FAIL'} [{card}]")
    check(acc > 0.95, f"{name}: validation accuracy {acc:.4f} <= 0.95")
    return mod, launches, {"step_ms": med, "samples_s": TRAIN_BATCH / med
                           * 1e3, "accuracy": acc}


def serve_trained(mx, mod, card, workdir):
    """Serve the trained mlp's checkpoint (its SoftmaxOutput label slot
    unfilled) in fp32 and bf16 through ModelServer on the card."""
    _, val = mnist_iters(mx)
    images = val.data[0][1]
    want = mod.predict(val).asnumpy()
    sizes, cuts = (1, 5, 16, 64, 3, 27, 8, 2, 33), [0]
    while cuts[-1] < len(images):
        cuts.append(min(len(images), cuts[-1] + sizes[len(cuts) % 9]))
    buckets = (1, 2, 4, 8, 16, 32, 64)
    shapes = [("data", (1, 1, 28, 28))]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "mlp")
        mod.save_checkpoint(prefix, TRAIN_EPOCHS)
        srv = mx.serving.ModelServer(max_queue_latency_ms=2.0,
                                     ctx=mx.gpu(0))
        srv.load_model("mlp", prefix=prefix, epoch=TRAIN_EPOCHS,
                       data_shapes=shapes, buckets=buckets)
        srv.load_model("mlp_bf16", model=mx.serving.ServedModel.load(
            prefix, TRAIN_EPOCHS, data_shapes=shapes, buckets=buckets,
            ctx=mx.gpu(0), dtype="bfloat16", name="mlp_bf16"))
        futs = [(a, b, srv.submit("mlp", {"data": images[a:b]}),
                 srv.submit("mlp_bf16", {"data": images[a:b]}))
                for a, b in zip(cuts, cuts[1:])]
        got32 = np.concatenate([f.result(120)[0].asnumpy()
                                for _, _, f, _ in futs])
        outs16 = [g.result(120)[0] for _, _, _, g in futs]
        srv.shutdown(drain=True)
    check(all(o.data.dtype == torch.bfloat16 for o in outs16),
          "bf16 serving did not answer in bf16")
    got16 = np.concatenate([o.asnumpy() for o in outs16])
    for label, got, ref, (rtol, atol) in (
            ("fp32 vs Module.predict", got32, want, SERVE_TRAIN_TOL),
            ("bf16 vs fp32 served", got16, got32, SERVE_BF16_TOL)):
        err = np.abs(got - ref)
        ok = got.shape == ref.shape and np.isfinite(got).all() and bool(
            (err <= rtol * np.abs(ref) + atol * np.abs(ref).max()).all())
        agree = float((got.argmax(1) == ref.argmax(1)).mean())
        print(f"train serve mlp {label}: {len(cuts) - 1} requests of "
              f"{len(images)} images, max_abs_err {err.max():.3e} (rtol "
              f"{rtol:g}, atol {atol:g}*max|ref|), argmax agreement "
              f"{agree:.4f} {'ok' if ok else 'FAIL'}")
        check(ok, f"served mlp {label} disagrees")


def train_phase(card, workdir):
    """Phase 6; returns K1's launches in the training run and the JSON's
    training numbers."""
    import incubator_mxnet_tpu_torch as mx
    old = os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
    out = {}
    try:
        for name, build in (("mlp", mlp_symbol), ("lenet", lenet_symbol)):
            if name == "mlp":
                os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
            else:
                os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
            sym = build(mx)
            parity_case(mx, name, sym)
            mod, launches, nums = fit_case(mx, name, sym, card)
            out[name] = dict(nums, k1_launches=launches)
            if name == "mlp":
                train, _ = mnist_iters(mx)
                out[name]["k1_share"] = profile_step(mx, mod, next(train),
                                                    card)
                serve_trained(mx, mod, card, workdir)
            del mod
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        if old is not None:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    return out["mlp"]["k1_launches"], out


def resnet_symbol(mx):
    """(net, symbol): gluon resnet50_v1(classes=1000) composed on
    Variable("data") + SoftmaxOutput, as bench.py's `_build_module`."""
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=CLASSES)
    return net, mx.sym.SoftmaxOutput(net(mx.sym.Variable("data")),
                                     name="softmax")


def resnet_init(mx):
    return mx.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                 magnitude=2)


def train_flops(sym, batch):
    """Operations of one training step at `batch`: 2 x the multiply-adds
    of every Convolution and FullyConnected forward (output elements x
    weight elements per output channel), times 3 for the forward and the
    backward's two products of the same size."""
    internals = sym.get_internals()
    shape = (batch,) + IMAGE
    _, outs, _ = internals.infer_shape(data=shape)
    args = dict(zip(sym.list_arguments(), sym.infer_shape(data=shape)[0]))
    macs = 0
    for (node, _), out in zip(internals._entries, outs):
        if not node.is_variable and node.op.name in ("Convolution",
                                                     "FullyConnected"):
            macs += math.prod(out) * math.prod(args[node.inputs[1][0].name]
                                               [1:])
    return 3 * 2 * macs


def resident_iter(mx, batch, dtype, n, seed=SEED):
    """n batches that are all the same random batch on the card, in
    `dtype` (bench.py `_synthetic_iter`: compute, not data loading)."""
    rng = np.random.RandomState(seed)
    ctx = mx.gpu(0)
    data = mx.nd.array(rng.rand(batch, *IMAGE).astype("f4"),
                       ctx=ctx).astype(dtype)
    label = mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"),
                        ctx=ctx)
    return resident(mx, data, label, n)


def resident(mx, data, label, n):
    """A DataIter that yields the one batch (`data`, `label`, NDArrays on
    the card) n times per epoch."""
    provide = ([mx.io.DataDesc("data", data.shape, dtype=data.dtype)],
               [mx.io.DataDesc("softmax_label", label.shape)])
    one = mx.io.DataBatch([data], [label], pad=0)

    class Resident(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=data.shape[0])
            self._i = 0

        @property
        def provide_data(self):
            return provide[0]

        @property
        def provide_label(self):
            return provide[1]

        def reset(self):
            self._i = 0

        def next(self):
            if self._i >= n:
                raise StopIteration
            self._i += 1
            return one

    return Resident()


def resnet_state(mod):
    """({parameter}, {momentum by parameter}, {aux}) as numpy."""
    args, auxs = mod.get_params()
    names = mod._exec_group.param_names
    return ({n: v.asnumpy() for n, v in args.items()},
            {names[i]: m.asnumpy() for i, m in mod._updater.states.items()},
            {n: v.asnumpy() for n, v in auxs.items()})


def as_float64(mod):
    """Turn a bound float32 Module's arrays (all but the labels) into
    float64 ones before init_params, for a check held in float64; the
    Module binds float32, as the JAX package's does."""
    exe = mod._exec_group.execs[0]
    labels = set(mod._exec_group.label_names)
    arrays = [a for n, a in exe.arg_dict.items() if n not in labels]
    arrays += [g for g in exe.grad_dict.values() if g is not None]
    for a in arrays + list(exe.aux_dict.values()):
        a._data = a.data.double()


def resnet_steps(mx, sym, ctx, batches, dtype, teacher=None, batch=None,
                 opt=None):
    """Fused steps (Module.fit_step) at `batch` in `dtype` on `ctx`, one
    per batch, from Xavier parameters under mx.random.seed(SEED); the loss
    of each step and the state before the first and after each.  With
    `teacher` (another run's states), step k starts from the teacher's
    state before it, cast to `dtype`.  `batch` and the optimizer's
    parameters `opt` default to RESNET_PARITY's and RESNET_OPT."""
    batch = batch or RESNET_PARITY[0]
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (batch,) + IMAGE)], [("softmax_label", (batch,))])
    if dtype == "float64":
        as_float64(mod)
    mx.random.seed(SEED)
    mod.init_params(resnet_init(mx))
    mod.init_optimizer(optimizer_params=opt or RESNET_OPT)
    losses, states = [], [resnet_state(mod)]
    for k, b in enumerate(batches):
        if teacher is not None and k:
            params, moms, auxs = teacher[k]
            mod.set_params(params, auxs)
            for i, n in enumerate(mod._exec_group.param_names):
                mod._updater.states[i]._set_data(moms[n])
        mod.fit_step(b, mx.metric.create("acc"))
        losses.append(cross_entropy(mod.get_outputs()[0], b.label[0]))
        states.append(resnet_state(mod))
    check(mod._fused_step is not None and mod._fused_step.steps ==
          len(batches), f"resnet parity on {ctx}: the fused step did not "
          "run every step")
    return losses, states


def bn_fed_biases(sym):
    """Biases of the convolutions whose output goes straight into a
    BatchNorm: the batch mean removes them, so their gradient is 0 in
    exact arithmetic and rounding noise in practice."""
    out = set()
    for node in sym._topo():
        if not node.is_variable and node.op.name == "BatchNorm":
            src = node.inputs[0][0]
            if not src.is_variable and src.op.name == "Convolution" and \
                    not src.attrs["no_bias"]:
                out.add(src.inputs[2][0].name)
    return out


def resnet_ratio(got, ref, zero, skip=()):
    """param_ratio over every array of `ref` not under `skip`; an array
    named in `zero` (a BatchNorm-fed bias: 0 plus float64 rounding) is
    held to |got| < RESNET_ZERO instead, its ratio max|got| /
    RESNET_ZERO."""
    worst = param_ratio(got, {n: c for n, c in ref.items()
                              if n not in zero}, skip)
    return max([worst] + [(float(np.abs(got[n]).max() / RESNET_ZERO), n)
                          for n in ref if n in zero
                          and not n.startswith(skip)])


def resnet_pool_routes(net, params, x, ctx):
    """Which element wins each window of ResNet-50's max-pool at these
    parameters and images, computed on `ctx` by the torch calls the port
    makes: conv1 (7x7/2), BatchNorm on the batch's statistics, relu, the
    3x3/2 max-pool over -inf padding."""
    import torch.nn.functional as F
    dev = ctx.torch_device
    conv, bn = net.features[0], net.features[1]
    w, g, b = (torch.from_numpy(params[p.name]).to(dev)
               for p in (conv.weight, bn.gamma, bn.beta))
    h = F.conv2d(torch.from_numpy(x).to(dev, w.dtype), w, stride=2,
                 padding=3)
    h = torch.relu(torch.native_batch_norm(h, g, b, None, None, True, 0.0,
                                           1e-5)[0])
    h = F.pad(h, (1, 1, 1, 1), value=-math.inf)
    return F.max_pool2d(h, 3, 2, return_indices=True)[1].cpu()


def resnet_flipped(mx, net, cpu_params, gpu_params, x):
    return int((resnet_pool_routes(net, cpu_params, x, mx.cpu()) !=
                resnet_pool_routes(net, gpu_params, x, mx.gpu(0))).sum())


def rel_l2(got, ref, zero):
    """Relative L2 distance of `got` from `ref` over every array of `ref`
    together, the names in `zero` left out."""
    keys = [n for n in ref if n not in zero]
    a = np.concatenate([got[n].ravel().astype(np.float64) for n in keys])
    b = np.concatenate([ref[n].ravel().astype(np.float64) for n in keys])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def resnet_parity(mx, net, sym):
    """Phase 7a: RESNET_PARITY fused steps of ResNet-50 at 224 on the card
    against the CPU from the same Xavier parameters and batches.

    float64, where the step is well conditioned: free running (the loss
    of every step within rtol), then each card step from the CPU's state
    before it (parameters, momenta and the 106 aux arrays after it within
    PARITY_TOL).  As for lenet (`parity_case`), a max-pool window whose
    two largest inputs tie within rounding may route its gradient to
    another pixel on the card: the windows are recomputed on both
    devices, and only conv1 and the BatchNorm under it are excused, and
    only at a step where a window flipped.

    float32: at batch 4 each of the 53 BatchNorms divides by a standard
    deviation taken over few values, so float32 rounding grows through
    the network to ~1e-4 of the output and ~2e-2 of every gradient (the
    JAX package's CPU step is as far from float64 as the port's).  No
    elementwise bound between two float32 devices holds there.  So each
    device runs each float32 step from the float64 CPU's state: its loss
    within rtol PARITY_TOL[0] of the float64 loss, and the card's
    parameters, momenta and aux arrays as close to the float64 step (in
    relative L2 norm) as the CPU's float32 step is, within a factor
    RESNET_ENVELOPE[0] plus RESNET_ENVELOPE[1]."""
    batch, steps = RESNET_PARITY
    rng = np.random.RandomState(SEED + 7)
    batches = [mx.io.DataBatch(
        [mx.nd.array(rng.rand(batch, *IMAGE).astype("f4"), ctx=mx.cpu())],
        [mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"),
                     ctx=mx.cpu())]) for _ in range(steps)]
    xs = [b.data[0].asnumpy() for b in batches]
    zero = bn_fed_biases(sym)
    t0 = time.perf_counter()
    cpu_loss, cpu = resnet_steps(mx, sym, mx.cpu(), batches, "float64")
    t_cpu = time.perf_counter() - t0
    gpu_loss, gpu = resnet_steps(mx, sym, mx.gpu(0), batches, "float64")
    _, forced = resnet_steps(mx, sym, mx.gpu(0), batches, "float64",
                             teacher=cpu)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    free_flips = sum(resnet_flipped(mx, net, c[0], g[0], x)
                     for c, g, x in zip(cpu, gpu, xs))
    excusable = (net.features[0].prefix, net.features[1].prefix)
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, x in enumerate(xs):
        n = resnet_flipped(mx, net, cpu[k][0], cpu[k][0], x)
        skip = excusable if n else ()
        after, ref = forced[k + 1], cpu[k + 1]
        held = max([held] + [resnet_ratio(a, r, zero, skip)
                             for a, r in zip(after, ref)])
        if n:
            flips.append(f"step {k + 1}: {n}")
            excused = max([excused] + [resnet_ratio(a, r, zero)
                                       for a, r in zip(after, ref)])
    ok = loss_err <= PARITY_TOL[0] and held[0] <= 1
    print(f"resnet parity float64: {steps} fused steps at batch {batch}, "
          f"card vs CPU (CPU {t_cpu:.1f} s): loss "
          f"{' '.join(f'{v:.6f}' for v in gpu_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); each step from "
          f"the CPU's state: parameters, momenta and {len(cpu[0][2])} aux "
          f"arrays at {held[0]:.3f} of the tolerance (worst {held[1]}) "
          f"(rtol {PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}*max|array|; "
          f"{len(zero)} BatchNorm-fed biases below {RESNET_ZERO:g}) "
          f"{'ok' if ok else 'FAIL'}")
    note = f"; at those steps conv1 and its BatchNorm at " \
        f"{excused[0]:.3f} of the tolerance (worst {excused[1]}), not " \
        "held" if flips else ""
    print(f"resnet parity float64: max-pool windows flipped between the "
          f"CPU and the card from the CPU's state: "
          f"{', '.join(flips) or 'none'}{note}; along the free-running "
          f"steps: {free_flips}")
    check(ok, "resnet: the card's float64 steps disagree with the CPU's")

    c32_loss, c32 = resnet_steps(mx, sym, mx.cpu(), batches, "float32",
                                 teacher=cpu)
    g32_loss, g32 = resnet_steps(mx, sym, mx.gpu(0), batches, "float32",
                                 teacher=cpu)
    factor, extra = RESNET_ENVELOPE
    worst, ok = [], True
    for k in range(steps):
        for what, i in (("parameters", 0), ("momenta", 1), ("aux", 2)):
            dc = rel_l2(c32[k + 1][i], cpu[k + 1][i], zero)
            dg = rel_l2(g32[k + 1][i], cpu[k + 1][i], zero)
            worst.append((dg / (factor * dc + extra), what, k + 1, dc, dg))
            ok = ok and dg <= factor * dc + extra
    loss32 = max(abs(v - c) / abs(c) for run in (c32_loss, g32_loss)
                 for v, c in zip(run, cpu_loss))
    ok = ok and loss32 <= PARITY_TOL[0]
    by_kind = {}
    for r in worst:
        by_kind[r[1]] = max(by_kind.get(r[1], r), r)
    print(f"resnet parity float32, each step from the float64 CPU's state:"
          f" loss within {loss32:.2e} of float64 on both (rtol "
          f"{PARITY_TOL[0]:g}); relative L2 distance from the float64 step,"
          f" card vs CPU: " + "; ".join(
              f"{what} {dg:.2e} vs {dc:.2e} (step {k})"
              for _, what, k, dc, dg in by_kind.values()) +
          f" (card <= {factor:g} x CPU + {extra:g}) {'ok' if ok else 'FAIL'}")
    check(ok, "resnet: the card's float32 steps are farther from float64 "
          "than the CPU's")


def resnet_lane(mx, sym, dtype, batch, warm, timed, card, peak,
                label="resnet", opt=None):
    """Phase 7b: the lane through the public Module.fit on one resident
    batch, `warm` + `timed` steps.  images/s over CUDA-synchronised
    window edges (bench.py `_Probe`), the median step ms between CUDA
    events recorded at each batch end, the loss of every step (computed
    on the card), peak memory; returns (module, numbers)."""
    it = resident_iter(mx, batch, dtype, warm + timed)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    events, losses, edges = [], [], {}
    ce = mx.metric.create("ce")       # -log(p + 1e-12), on the card

    def probe(p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        label = mod._exec_group.execs[0].arg_dict["softmax_label"]
        total, n = ce.device_update([label], mod.get_outputs())
        losses.append(total / n)
        if p.nbatch in (warm - 1, warm + timed - 1):
            torch.cuda.synchronize()
            edges[p.nbatch] = time.perf_counter()
            edges["acc"] = p.eval_metric.get()[1]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=1, optimizer="sgd",
            optimizer_params=dict(opt or RESNET_OPT,
                                  multi_precision=dtype != "float32",
                                  rescale_grad=1.0 / batch),
            eval_metric="acc", initializer=resnet_init(mx),
            batch_end_callback=probe, kvstore=None)
    wall = time.perf_counter() - t0
    steps = warm + timed
    fused = mod._fused_step
    check(fused is not None and fused.steps == steps,
          f"{label} {dtype}: the fused step ran "
          f"{fused.steps if fused else 0} of {steps} steps")
    loss = torch.stack(losses).cpu().numpy()
    images_s = batch * timed / (edges[warm + timed - 1] - edges[warm - 1])
    step_ms = [a.elapsed_time(b) for a, b in zip(events[warm - 1:],
                                                 events[warm:])]
    med = statistics.median(step_ms)
    flops = train_flops(sym, batch)
    mfu = images_s * flops / batch / peak
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    acc = edges["acc"]
    ok = bool(np.isfinite(loss).all()) and loss[-1] < loss[0] and \
        math.isfinite(acc)
    print(f"{label} lane {dtype} batch {batch}: {steps} steps through "
          f"Module.fit in {wall:.2f} s ({warm} warm), fused step every "
          f"step; {images_s:.1f} images/s over the {timed} timed steps; "
          f"step median {med:.3f} ms (p10 {np.percentile(step_ms, 10):.3f}"
          f", p90 {np.percentile(step_ms, 90):.3f}, CUDA events); "
          f"{flops / batch / 1e9:.2f} GFLOP per image; peak memory "
          f"{mem:.2f} GiB [{card}]")
    print(f"{label} lane {dtype} batch {batch}: loss (cross-entropy of "
          f"the outputs, metric.CrossEntropy) first "
          f"{loss[0]:.4f}, last {loss[-1]:.4f}, every "
          f"{' '.join(f'{v:.3f}' for v in loss[::8])}; train acc over the "
          f"fit {acc:.4f} {'ok' if ok else 'FAIL'}")
    print(f"{'' if label == 'resnet' else label + ' '}mfu {dtype} "
          f"{mfu:.4f} (of {peak / 1e12:.0f} TFLOP/s) [{card}]")
    check(ok, f"{label} {dtype}: loss not finite or not falling, or acc "
          "not finite")
    return mod, {"images_s": images_s, "step_ms": med, "mfu": mfu,
                 "peak_gib": mem}


def kernel_class(name, classes=KERNEL_CLASSES):
    for label, keys in classes:
        if any(k in name for k in keys):
            return label
    return "other"


def resnet_profile(mx, mod, card):
    """Phase 7c: one warm bf16 step (fit_step) under torch.profiler: the
    device's busy share of the step, device ms by kernel class, and the
    host ms the step took to enqueue."""
    batch = mod._exec_group.batch_size
    it = resident_iter(mx, batch, "bfloat16", 1)
    one = next(it)
    metric = mx.metric.create("acc")
    return profile_one_step(lambda: mod.fit_step(one, metric), card,
                            "resnet profile", batch)


def profile_one_step(step, card, label, batch, tries=3, dtype="bf16",
                     classes=KERNEL_CLASSES):
    """`step()` once to warm, then once under torch.profiler (retried if
    the profiler recorded no kernel): the host ms to enqueue it, the
    kernels, device ms by kernel class (`classes`), the device's busy
    share; printed on lines starting with `label`."""
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, f"{label}: the profiler saw no device activity in a step")
    by_class, other, busy, edge = {}, {}, 0.0, -math.inf
    for start, end, name in spans:
        cls = kernel_class(name, classes)
        by_class[cls] = by_class.get(cls, 0.0) + (end - start)
        if cls == "other":
            other[name] = other.get(name, 0.0) + (end - start)
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    total = sum(by_class.values())
    print(f"{label}: one warm {dtype} step at batch {batch}: "
          f"{host_ms:.2f} ms of host time to enqueue, {wall_ms:.2f} ms to "
          f"finish, {len(spans)} kernels, device time {total / 1e3:.2f} ms, "
          f"device busy {busy / 1e3 / wall_ms:.3f} of the step [{card}]")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"{label}: {us / 1e3:9.3f} ms {us / total:6.3f} {cls}")
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:3]:
        print(f"{label}: other: {us / 1e3:8.3f} ms {name[:90]}")
    return {"busy": busy / 1e3 / wall_ms, "host_ms": host_ms,
            "device_ms": total / 1e3, "kernels": len(spans),
            "by_class": {cls: us / 1e3 for cls, us in by_class.items()}}


def resnet_serve(mx, sym, card, workdir):
    """Phase 7d: RESNET_SERVE fp32 steps through Module.fit, the
    checkpoint saved, loaded into serving.ModelServer, requests of 1-8
    images answered and held to Module.predict (BatchNorm in inference
    mode, on the moving statistics the steps left)."""
    batch, steps = RESNET_SERVE
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mx.random.seed(SEED)
    mod.fit(resident_iter(mx, batch, "float32", steps, seed=SEED + 1),
            num_epoch=1, optimizer="sgd",
            optimizer_params=dict(RESNET_OPT, rescale_grad=1.0 / batch),
            eval_metric="acc", initializer=resnet_init(mx), kvstore=None)
    check(mod._fused_step.steps == steps, "resnet serve: fused step")
    rng = np.random.RandomState(SEED + 2)
    reqs = [rng.rand(n, *IMAGE).astype("f4") for n in RESNET_SERVE_SIZES]
    want = [mod.predict(x).asnumpy() for x in reqs]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "resnet50")
        mod.save_checkpoint(prefix, steps)
        srv = mx.serving.ModelServer(max_queue_latency_ms=2.0,
                                     ctx=mx.gpu(0))
        srv.load_model("resnet50", prefix=prefix, epoch=steps,
                       data_shapes=[("data", (1,) + IMAGE)],
                       buckets=RESNET_BUCKETS)
        futs = [srv.submit("resnet50", {"data": x}) for x in reqs]
        got = [f.result(300)[0].asnumpy() for f in futs]
        srv.shutdown(drain=True)
    rtol, atol = SERVE_TRAIN_TOL
    err = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    ok = all(g.shape == w.shape and np.isfinite(g).all() and bool(
        (np.abs(g - w) <= rtol * np.abs(w) + atol * np.abs(w).max()).all())
        for g, w in zip(got, want))
    agree = float(np.mean(np.concatenate([g.argmax(1) == w.argmax(1)
                                          for g, w in zip(got, want)])))
    print(f"resnet serve: {steps} fp32 steps at batch {batch}, checkpoint "
          f"served, {len(reqs)} requests of {sum(RESNET_SERVE_SIZES)} "
          f"images (buckets {RESNET_BUCKETS}) vs Module.predict: "
          f"max_abs_err {err:.3e} (rtol {rtol:g}, atol {atol:g}*max|ref|),"
          f" argmax agreement {agree:.4f} {'ok' if ok else 'FAIL'}")
    check(ok, "served ResNet-50 disagrees with Module.predict")


def resnet_phase(card, workdir):
    """Phase 7; returns the numbers the summary line prints."""
    import incubator_mxnet_tpu_torch as mx
    net, sym = resnet_symbol(mx)
    args, _, aux = sym.infer_shape(data=(RESNET_BATCH,) + IMAGE)
    learned = [a for n, a in zip(sym.list_arguments(), args)
               if n not in ("data", "softmax_label")]
    print(f"resnet: resnet50_v1 composed: {len(learned)} learned arguments "
          f"of {sum(math.prod(a) for a in learned)} values, {len(aux)} aux "
          f"of {sum(math.prod(a) for a in aux)}")
    out = {}
    t0 = time.perf_counter()
    resnet_parity(mx, net, sym)
    out["parity_s"] = time.perf_counter() - t0
    mod, out["bf16"] = resnet_lane(mx, sym, "bfloat16", RESNET_BATCH,
                                   RESNET_WARM, RESNET_TIMED, card,
                                   PEAK_FLOPS[BF16])
    out["profile"] = resnet_profile(mx, mod, card)
    del mod
    torch.cuda.empty_cache()
    batch, steps = RESNET_FP32
    mod, out["fp32"] = resnet_lane(mx, sym, "float32", batch, steps // 2,
                                   steps - steps // 2, card,
                                   FP32_CUDA_CORE_FLOPS)
    del mod
    torch.cuda.empty_cache()
    resnet_serve(mx, sym, card, workdir)
    return out


# -- phase 8: gluon's imperative training ------------------------------------

def gluon_state(mx, net, trainer):
    """{full parameter name: value, "name:momentum": momentum} as numpy
    (`compat.weights`: the parameters, BatchNorm's running statistics
    included, and the trainer's optimizer states)."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_to_numpy, trainer_states_to_numpy)
    state = block_params_to_numpy(net)
    names = [p.name for p in trainer._params]
    for i, mom in trainer_states_to_numpy(trainer).items():
        state[names[i] + ":momentum"] = mom
    return state


def gluon_load(mx, net, trainer, state):
    """Start `net` and `trainer` from `state` (`gluon_state`'s form)
    through `compat.weights`."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy, trainer_states_from_numpy)
    block_params_from_numpy(net, {n: v for n, v in state.items()
                                  if ":" not in n})
    index = {p.name: i for i, p in enumerate(trainer._params)}
    trainer_states_from_numpy(trainer, {
        index[n[:-len(":momentum")]]: v for n, v in state.items()
        if n.endswith(":momentum")})


def v2_net(mx, ctx, values, dtype):
    """resnet50_v2 on `ctx` with the parameter `values` (full names: the
    fixed prefix makes every instance's names the same), cast to
    `dtype`."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy)
    net = mx.gluon.model_zoo.vision.resnet50_v2(classes=CLASSES,
                                                prefix=V2_PREFIX)
    net.initialize(ctx=ctx)
    block_params_from_numpy(net, values, ctx=ctx)
    net.cast(dtype)
    return net


def v2_initial_values(mx):
    """Xavier(gaussian, in, 2) parameters of resnet50_v2 under the seed,
    the deferred shapes finished by one predict-mode forward on the CPU,
    as numpy."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_to_numpy)
    net = mx.gluon.model_zoo.vision.resnet50_v2(classes=CLASSES,
                                                prefix=V2_PREFIX)
    mx.random.seed(SEED)
    net.initialize(resnet_init(mx), ctx=mx.cpu())
    net(mx.nd.zeros((1,) + IMAGE, ctx=mx.cpu()))
    return block_params_to_numpy(net)


def v2_steps(mx, ctx, values, batches, teacher=None, hybrid=True):
    """GLUON_PARITY steps of BASELINE #3's plain loop (hybridized
    resnet50_v2, record / backward / Trainer.step, SGD lr 0.05 momentum
    0.9) in float64 on `ctx`: the loss of each step and the state before
    the first and after each.  With `teacher` (another run's states),
    step k starts from the teacher's state before it."""
    net = v2_net(mx, ctx, values, "float64")
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", RESNET_OPT)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses, states = [], [gluon_state(mx, net, trainer)]
    for k, (x, y) in enumerate(batches):
        if teacher is not None and k:
            gluon_load(mx, net, trainer, teacher[k])
        data = mx.nd.array(x, ctx=ctx, dtype="float64")
        label = mx.nd.array(y, ctx=ctx)
        with mx.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(data.shape[0])
        losses.append(float(loss.asnumpy().mean()))
        states.append(gluon_state(mx, net, trainer))
    return losses, states


def held_ratio(got, ref, skip=()):
    """The largest |got - ref| / (rtol |ref| + atol max|ref|) (PARITY_TOL)
    over every array of `ref` whose name does not start with one of
    `skip`, and its name; an array that is all zeros must stay zero."""
    rtol, atol = PARITY_TOL
    worst = (0.0, "none")
    for n, c in ref.items():
        if n.startswith(skip):
            continue
        bound = rtol * np.abs(c) + atol * np.abs(c).max()
        diff = np.abs(got[n] - c)
        r = float((diff / np.where(bound > 0, bound, 1.0)).max()) \
            if bound.max() > 0 else (0.0 if not diff.any() else math.inf)
        worst = max(worst, (r, n))
    return worst


def v2_pool_routes(net, params, x, ctx):
    """Which element wins each window of resnet50_v2's max-pool, computed
    on `ctx` by the torch calls the port makes: the data's BatchNorm
    (gamma fixed at 1), conv0 (7x7/2), BatchNorm on the batch's
    statistics, relu, the 3x3/2 max-pool over -inf padding."""
    import torch.nn.functional as F
    dev = ctx.torch_device
    f = net.features
    bn0, conv, bn1 = f[0], f[1], f[2]

    def t(p):
        return torch.from_numpy(params[p.name]).to(dev, torch.float64)
    h = torch.from_numpy(x).to(dev, torch.float64)
    beta0 = t(bn0.beta)
    h = torch.native_batch_norm(h, torch.ones_like(beta0), beta0, None,
                                None, True, 0.0, 1e-5)[0]
    h = F.conv2d(h, t(conv.weight), stride=2, padding=3)
    h = torch.relu(torch.native_batch_norm(h, t(bn1.gamma), t(bn1.beta),
                                           None, None, True, 0.0, 1e-5)[0])
    h = F.pad(h, (1, 1, 1, 1), value=-math.inf)
    return F.max_pool2d(h, 3, 2, return_indices=True)[1].cpu()


def v2_flipped(mx, net, cpu_params, gpu_params, x):
    return int((v2_pool_routes(net, cpu_params, x, mx.cpu()) !=
                v2_pool_routes(net, gpu_params, x, mx.gpu(0))).sum())


def v2_grads(mx, ctx, values, x, y, hybrid):
    """One recorded step's loss and gradients of resnet50_v2 in float64
    from `values`: {name: numpy}."""
    net = v2_net(mx, ctx, values, "float64")
    if hybrid:
        net.hybridize()
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    data = mx.nd.array(x, ctx=ctx, dtype="float64")
    with mx.autograd.record():
        loss = loss_fn(net(data), mx.nd.array(y, ctx=ctx))
    loss.backward()
    out = {p.name: p.grad().asnumpy() for p in net.collect_params().values()
           if p.grad_req != "null"}
    out["loss"] = loss.asnumpy()
    return out


def gluon_parity(mx):
    """Phase 8a: BASELINE #3's plain loop on hybridized resnet50_v2 at
    batch 4, 224, float64, the card against the CPU from the same
    parameters and momenta (`compat.weights`) and batches: free running,
    every step's loss within rtol; each card step from the CPU's state
    before it, parameters, momenta and moving statistics after it within
    PARITY_TOL (7a's gates; a max-pool window that flips between the
    devices excuses conv0 and the BatchNorm under it at that step, as
    in 7a).  Then one step on the card hybridized against not, cuDNN in
    its deterministic algorithms: the loss and every gradient within
    HYBRID_TOL."""
    batch, steps = GLUON_PARITY
    rng = np.random.RandomState(SEED + 8)
    batches = [(rng.rand(batch, *IMAGE), rng.randint(0, CLASSES, batch)
                .astype("f4")) for _ in range(steps)]
    values = v2_initial_values(mx)
    t0 = time.perf_counter()
    cpu_loss, cpu = v2_steps(mx, mx.cpu(), values, batches)
    t_cpu = time.perf_counter() - t0
    gpu_loss, gpu = v2_steps(mx, mx.gpu(0), values, batches)
    _, forced = v2_steps(mx, mx.gpu(0), values, batches, teacher=cpu)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    probe = v2_net(mx, mx.cpu(), values, "float64")
    free_flips = sum(v2_flipped(mx, probe, c, g, x)
                     for c, g, (x, _) in zip(cpu, gpu, batches))
    excusable = (probe.features[1].prefix, probe.features[2].prefix)
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, (x, _) in enumerate(batches):
        n = v2_flipped(mx, probe, cpu[k], cpu[k], x)
        held = max(held, held_ratio(forced[k + 1], cpu[k + 1],
                                    excusable if n else ()))
        if n:
            flips.append(f"step {k + 1}: {n}")
            excused = max(excused, held_ratio(forced[k + 1], cpu[k + 1]))
    ok = loss_err <= PARITY_TOL[0] and held[0] <= 1
    n_arrays = len(cpu[-1])
    print(f"gluon parity float64: hybridized resnet50_v2, {steps} steps of "
          f"record/backward/Trainer.step at batch {batch}, card vs CPU "
          f"(CPU {t_cpu:.1f} s): loss "
          f"{' '.join(f'{v:.6f}' for v in gpu_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); each step from "
          f"the CPU's state (compat.weights): {n_arrays} parameter, moving "
          f"statistic and momentum arrays at {held[0]:.3f} of the "
          f"tolerance (worst {held[1]}) (rtol {PARITY_TOL[0]:g}, atol "
          f"{PARITY_TOL[1]:g}*max|array|) {'ok' if ok else 'FAIL'}")
    note = f"; at those steps conv0 and its BatchNorm at " \
        f"{excused[0]:.3f} of the tolerance (worst {excused[1]}), not " \
        "held" if flips else ""
    print(f"gluon parity float64: max-pool windows flipped between the CPU "
          f"and the card from the CPU's state: {', '.join(flips) or 'none'}"
          f"{note}; along the free-running steps: {free_flips}")
    check(ok, "gluon: the card's float64 steps disagree with the CPU's")

    x, y = batches[0]
    # cuDNN's default backward algorithms add with atomics, so two runs of
    # one graph differ in the last bits; its deterministic ones do not
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        hyb = v2_grads(mx, mx.gpu(0), values, x, y, True)
        eager = v2_grads(mx, mx.gpu(0), values, x, y, False)
    rtol, atol = HYBRID_TOL
    worst, ok = (0.0, "none"), True
    for n, ref in eager.items():
        diff = np.abs(hyb[n] - ref)
        bound = rtol * np.abs(ref) + atol * np.abs(ref).max()
        ok = ok and bool((diff <= bound).all())
        worst = max(worst, (float(diff.max()), n))
    print(f"gluon hybridize: one card step of resnet50_v2 hybridized vs "
          f"eager in float64: loss and {len(eager) - 1} gradients, max abs "
          f"diff {worst[0]:.3e} ({worst[1]}) (rtol {rtol:g}, atol "
          f"{atol:g}*max|g|) {'ok' if ok else 'FAIL'}")
    check(ok, "gluon: the hybridized step's gradients differ from eager")


def gluon_net_bf16(mx, ctor):
    """bench.py `_run_gluon`'s net: `ctor(classes=1000)`, Xavier(gaussian,
    in, 2) on the card under the seed, cast to bfloat16, the deferred
    shapes finished by one predict-mode forward."""
    ctx = mx.gpu(0)
    net = ctor(classes=CLASSES)
    mx.random.seed(SEED)
    net.initialize(resnet_init(mx), ctx=ctx)
    net.cast("bfloat16")
    net(mx.nd.zeros((1,) + IMAGE, ctx=ctx, dtype="bfloat16"))
    return net


def resident_batch(mx, batch, seed=SEED):
    """One random batch on the card, the data in bfloat16 (bench.py's
    gluon lane: compute, not data loading)."""
    rng = np.random.RandomState(seed)
    ctx = mx.gpu(0)
    data = mx.nd.array(rng.rand(batch, *IMAGE).astype("f4"),
                       ctx=ctx).astype("bfloat16")
    label = mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"),
                        ctx=ctx)
    return data, label


class _LaneProbe:
    """Estimator handler (bench.py `_run_gluon`'s Probe): a CUDA event and
    the batch's mean loss (on the card) at every batch end, the window's
    edges CUDA-synchronised on the host clock.  At the first edge it
    keeps the peak memory so far (`warm_peak`, GiB) and resets the
    counter, so `peaks()` tells the warm steps' one-time allocations
    from a steady step's.  `base`: GiB allocated before the lane built
    anything, once the earlier phases' garbage is collected (a reference
    cycle of an earlier net would otherwise count in this lane's
    peak)."""

    def __init__(self, warm, timed):
        self.warm, self.timed = warm, timed
        self.events, self.losses, self.edges = [], [], {}
        self.warm_peak = 0.0
        gc.collect()
        torch.cuda.synchronize()
        self.base = torch.cuda.memory_allocated() / 2 ** 30

    def peaks(self):
        """(peak memory over the whole run, over the timed steps), GiB."""
        timed = torch.cuda.max_memory_allocated() / 2 ** 30
        return max(self.warm_peak, timed), timed

    def train_begin(self, est):
        pass

    def epoch_begin(self, est):
        pass

    def batch_begin(self, est):
        pass

    def batch_end(self, est):
        self.mark(est._fused.last_loss.data if est._fused else None)

    def mark(self, losses):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append(ev)
        if losses is not None:      # the eager loop keeps no loss
            self.losses.append(losses.detach().float().mean())
        if len(self.events) in (self.warm, self.warm + self.timed):
            torch.cuda.synchronize()
            self.edges[len(self.events)] = time.perf_counter()
            if len(self.events) == self.warm:
                self.warm_peak = torch.cuda.max_memory_allocated() / 2 ** 30
                torch.cuda.reset_peak_memory_stats()

    def epoch_end(self, est):
        pass

    def train_end(self, est):
        pass


def lane_numbers(label, probe, batch, flops, steps_run, card, module_s,
                 acc, wall):
    """Print a lane's images/s, step median, mfu, peak memory and the
    ratio to the Module lane; check the loss is finite and falls and the
    accuracy finite."""
    warm, timed = probe.warm, probe.timed
    loss = torch.stack(probe.losses).cpu().numpy()
    images_s = batch * timed / (probe.edges[warm + timed] -
                                probe.edges[warm])
    step_ms = [a.elapsed_time(b) for a, b in
               zip(probe.events[warm - 1:], probe.events[warm:])]
    med = statistics.median(step_ms)
    mfu = images_s * flops / batch / PEAK_FLOPS[BF16]
    mem, steady = probe.peaks()
    ok = bool(np.isfinite(loss).all()) and loss[-1] < loss[0] and \
        math.isfinite(acc)
    print(f"{label} batch {batch}: {steps_run} steps in {wall:.2f} s "
          f"({warm} warm); {images_s:.1f} images/s over the {timed} timed "
          f"steps; step median {med:.3f} ms (p10 "
          f"{np.percentile(step_ms, 10):.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}, CUDA events); "
          f"{flops / batch / 1e9:.2f} GFLOP per image; peak memory "
          f"{mem:.2f} GiB ({steady:.2f} over the timed steps, "
          f"{probe.base:.2f} allocated before the lane); "
          f"gluon_vs_module {images_s / module_s:.3f} [{card}]")
    print(f"{label} batch {batch}: loss (the loss block's mean) first "
          f"{loss[0]:.4f}, last {loss[-1]:.4f}, every "
          f"{' '.join(f'{v:.3f}' for v in loss[::8])}; train acc "
          f"{acc:.4f} {'ok' if ok else 'FAIL'}")
    print(f"{label} mfu bfloat16 {mfu:.4f} (of "
          f"{PEAK_FLOPS[BF16] / 1e12:.0f} TFLOP/s) [{card}]")
    check(ok, f"{label}: loss not finite or not falling, or acc not "
          "finite")
    return {"images_s": images_s, "step_ms": med, "mfu": mfu,
            "peak_gib": mem, "steady_gib": steady,
            "gluon_vs_module": images_s / module_s}


def bench_estimator(mx, batch, steps, probe):
    """bench.py `_run_gluon`'s Estimator.fit of resnet50_v1 in bfloat16
    on one resident batch, `steps` batches: (estimator, batch, wall s)."""
    net = gluon_net_bf16(mx, mx.gluon.model_zoo.vision.resnet50_v1)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", dict(
        RESNET_OPT, multi_precision=True, rescale_grad=1.0 / batch))
    est = mx.gluon.contrib.estimator.Estimator(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
        train_metrics=[mx.metric.Accuracy()], trainer=trainer)
    data, label = resident_batch(mx, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    est.fit(iter([(data, label)] * steps), epochs=1,
            event_handlers=[probe])
    return est, (data, label), time.perf_counter() - t0


def bench_gluon_eager(mx, card, fused):
    """Phase 8b: bench.py's gluon lane as `bench_gluon_lane` runs it, with
    the fused step switched off (MXNET_FUSED_TRAIN_STEP=0), so Estimator
    runs its eager loop (record, backward, Trainer.step, metric.update):
    images/s, step median and peak memory beside the fused step's."""
    batch = RESNET_BATCH
    probe = _LaneProbe(GLUON_WARM, GLUON_TIMED)
    prev = os.environ.get("MXNET_FUSED_TRAIN_STEP")
    os.environ["MXNET_FUSED_TRAIN_STEP"] = "0"
    try:
        est, _, wall = bench_estimator(mx, batch, GLUON_WARM + GLUON_TIMED,
                                       probe)
    finally:
        if prev is None:
            del os.environ["MXNET_FUSED_TRAIN_STEP"]
        else:
            os.environ["MXNET_FUSED_TRAIN_STEP"] = prev
    warm, timed = probe.warm, probe.timed
    images_s = batch * timed / (probe.edges[warm + timed] -
                                probe.edges[warm])
    med = statistics.median(a.elapsed_time(b) for a, b in
                            zip(probe.events[warm - 1:], probe.events[warm:]))
    mem, steady = probe.peaks()
    acc = est.train_metrics[0].get()[1]
    ok = est._fused is None and math.isfinite(acc)
    print(f"gluon lane Estimator.fit resnet50_v1 eager loop "
          f"(MXNET_FUSED_TRAIN_STEP=0) batch {batch}: "
          f"{GLUON_WARM + GLUON_TIMED} steps in {wall:.2f} s; "
          f"{images_s:.1f} images/s over the {timed} timed steps; step "
          f"median {med:.3f} ms (CUDA events); peak memory {mem:.2f} GiB "
          f"({steady:.2f} over the timed steps, {probe.base:.2f} allocated "
          f"before the lane); train acc {acc:.4f}; fused "
          f"step / eager loop images/s {fused['images_s'] / images_s:.3f}, "
          f"step median {fused['step_ms'] / med:.3f}, timed steps' peak "
          f"memory {fused['steady_gib'] / steady:.3f} [{card}] "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "gluon lane: the eager loop took the fused step, or its "
          "accuracy is not finite")
    return {"images_s": images_s, "step_ms": med, "peak_gib": mem,
            "steady_gib": steady}


def bench_gluon_lane(mx, sym_v1, card, module_s):
    """Phase 8b, bench.py's gluon lane (`_run_gluon`, defaults :683-687):
    resnet50_v1 in bfloat16 through the public Estimator.fit on one
    resident batch of GLUON_BATCH, GLUON_WARM + GLUON_TIMED batches; the
    gluon fused step must take every one."""
    batch = RESNET_BATCH
    probe = _LaneProbe(GLUON_WARM, GLUON_TIMED)
    steps = GLUON_WARM + GLUON_TIMED
    est, (data, label), wall = bench_estimator(mx, batch, steps, probe)
    fused = est._fused
    check(fused is not None and fused.steps == steps,
          f"gluon lane: the fused step ran "
          f"{fused.steps if fused else 0} of {steps} batches")
    out = lane_numbers("gluon lane Estimator.fit resnet50_v1", probe, batch,
                       train_flops(sym_v1, batch), steps, card, module_s,
                       est.train_metrics[0].get()[1], wall)
    out["profile"] = profile_one_step(
        lambda: fused(data, label, batch), card,
        "gluon profile Estimator fused step", batch)
    return out


def baseline3_lane(mx, card, module_s, hybrid, warm, timed):
    """Phase 8b, BASELINE config #3: hybridized resnet50_v2 in bfloat16
    through the plain loop (record, backward, Trainer.step; SGD lr 0.05
    momentum 0.9, multi_precision) on one resident batch of RESNET_BATCH,
    `warm` + `timed` steps.  With ``hybrid=False`` the same loop on the
    net as built, op by op through `ndarray.invoke`: gluon's most common
    path, and the autograd tape's largest."""
    batch = RESNET_BATCH
    probe = _LaneProbe(warm, timed)
    net = gluon_net_bf16(mx, mx.gluon.model_zoo.vision.resnet50_v2)
    if hybrid:
        net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(RESNET_OPT, multi_precision=True))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    metric = mx.metric.Accuracy()
    data, label = resident_batch(mx, batch, seed=SEED + 1)

    def step():
        with mx.autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        loss.backward()
        trainer.step(batch)
        metric.update([label], [out])
        return loss

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(warm + timed):
        probe.mark(step().data)
    wall = time.perf_counter() - t0
    sym = mx.sym.SoftmaxOutput(mx.gluon.model_zoo.vision.resnet50_v2(
        classes=CLASSES)(mx.sym.Variable("data")), name="softmax")
    what = "hybridized" if hybrid else "un-hybridized"
    out = lane_numbers(f"gluon lane {what} resnet50_v2 plain loop", probe,
                       batch, train_flops(sym, batch), warm + timed,
                       card, module_s, metric.get()[1], wall)
    out["profile"] = profile_one_step(
        step, card, f"gluon profile {what} resnet50_v2 step", batch)
    return out


def gluon_phase(card, module_s):
    """Phase 8; returns the numbers the summary line prints."""
    import incubator_mxnet_tpu_torch as mx
    out = {}
    t0 = time.perf_counter()
    gluon_parity(mx)
    out["parity_s"] = time.perf_counter() - t0
    _, sym_v1 = resnet_symbol(mx)
    out["bench"] = bench_gluon_lane(mx, sym_v1, card, module_s)
    torch.cuda.empty_cache()
    out["bench_eager"] = bench_gluon_eager(mx, card, out["bench"])
    torch.cuda.empty_cache()
    out["baseline3"] = baseline3_lane(mx, card, module_s, True, V2_WARM,
                                      V2_TIMED)
    torch.cuda.empty_cache()
    out["eager_v2"] = baseline3_lane(mx, card, module_s, False, *V2_EAGER)
    torch.cuda.empty_cache()
    return out


# -- phase 9: the transformer LM served at GPT-2 small's widths -------------

def lm_values(cfg, seed=SEED):
    """{name: float32 numpy} under the llm.model names, GPT-2's
    initialisation: N(0, 0.02) for the embedding and the projections,
    out_proj and fc2 at 0.02 / sqrt(2 L) (GPT-2's residual scaling); so
    that every parameter takes part, gammas 1 + N(0, 0.02) and betas and
    biases N(0, 0.02)."""
    rng = np.random.default_rng(seed)
    c, f = cfg.hidden, cfg.hidden * cfg.ffn_mult
    resid = LM_STD / math.sqrt(2 * cfg.num_layers)

    def normal(shape, std=LM_STD, mean=0.0):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= std
        a += mean
        return a

    out = {"lm_embed_weight": normal((cfg.vocab_size, c)),
           "lm_final_ln_gamma": normal((c,), mean=1.0),
           "lm_final_ln_beta": normal((c,))}
    for i in range(cfg.num_layers):
        pre = f"lm_block{i}_"
        for ln in ("ln1", "ln2"):
            out[f"{pre}{ln}_gamma"] = normal((c,), mean=1.0)
            out[f"{pre}{ln}_beta"] = normal((c,))
        for name, shape, std in (("qkv", (3 * c, c), LM_STD),
                                 ("out_proj", (c, c), resid),
                                 ("fc1", (f, c), LM_STD),
                                 ("fc2", (c, f), resid)):
            out[f"{pre}{name}_weight"] = normal(shape, std)
            out[f"{pre}{name}_bias"] = normal(shape[:1])
    return out


def lm_padded(tokens):
    """(1, bucket) int32 of `tokens` padded with zeros to its bucket of
    LM_BUCKETS."""
    n = len(tokens)
    out = np.zeros((1, next(b for b in LM_BUCKETS if n <= b)), np.int32)
    out[0, :n] = tokens
    return out


def lm_clear(logits, share):
    """Per row of `logits` (..., V): whether its top-2 margin exceeds
    share * max|logit| of the row (a near tie where it does not)."""
    top2 = logits.float().topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > \
        share * logits.float().abs().amax(-1)


def held(got, ref, tol, what):
    """max |got - ref| / (rtol*|ref| + atol*max|ref|), compared on the
    CPU in float32; fails above 1."""
    got, ref = got.detach().float().cpu(), ref.detach().float().cpu()
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs "
          f"{tuple(ref.shape)}")
    rtol, atol = tol
    bound = (rtol * ref.abs() + atol * ref.abs().max()).clamp_min(1e-30)
    ratio = ((got - ref).abs() / bound).max().item()
    check(ratio <= 1.0, f"{what}: {ratio:.3f} of the tolerance")
    return ratio


def lm_parity(mx, cfg, params, card):
    """Phase 9a: the decode plane on the card against the port on the
    CPU from the same parameters: prefills of LM_PROMPTS into slots 0-2
    (one per bucket), then LM_TICKS decode ticks fed the CPU's tokens;
    every call's logits, argmax where the CPU's margin is clear, and the
    caches' written rows.  On the card: the last step against a prefill
    of the prompt it had seen, and the 200-token prefill against the
    hybridized gluon TransformerLM's forward at its last position.  Then
    the same calls in bf16 (parameters and cache) against fp32 on the
    card."""
    from incubator_mxnet_tpu_torch.compat.weights import lm_params_from_numpy
    from incubator_mxnet_tpu_torch.llm import (DecodePrograms, LMConfig,
                                               TransformerLM, init_kv_cache,
                                               stack_lm_params)
    rng = np.random.default_rng(SEED + 9)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LM_PROMPTS]
    lanes = {}
    for name, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
        progs = DecodePrograms(cfg, stack_lm_params(params, cfg, ctx),
                               label=name)
        lanes[name] = (progs,) + init_kv_cache(cfg, LM_SLOTS, ctx)
    out = {"worst": 0.0, "ties": 0, "rows": 0}
    calls = []   # (kind, args, the card's fp32 logits) for the bf16 replay

    def run(kind, *args):
        res = {n: getattr(p, kind)(p.params, ck, cv, *args)
               for n, (p, ck, cv) in lanes.items()}
        want, got = res["cpu"][3], res["card"][3]
        out["worst"] = max(out["worst"],
                           held(got, want, LM_TOL, f"9a {kind} logits"))
        clear = lm_clear(want, LM_TIE)
        out["ties"] += int((~clear).sum())
        out["rows"] += clear.numel()
        same = res["card"][2].cpu().long() == want.argmax(-1)
        check(bool(same[clear].all()),
              f"9a {kind}: the card's argmax differs at a clear margin")
        calls.append((kind, args, got.float().clone()))
        return res["cpu"][2].numpy()

    tokens = np.zeros(LM_SLOTS, np.int32)
    positions = np.zeros(LM_SLOTS, np.int32)
    seqs = []
    for slot, p in enumerate(prompts):
        tok = int(run("prefill", lm_padded(p), slot, len(p)))
        tokens[slot], positions[slot] = tok, len(p)
        seqs.append(list(p) + [tok])
    prefill_last = calls[-1][2]      # the longest prompt's, on the card
    for _ in range(LM_TICKS):
        nxt = run("step", tokens.copy(), positions.copy())
        for slot, seq in enumerate(seqs):
            tokens[slot] = nxt[slot]
            positions[slot] += 1
            seq.append(int(nxt[slot]))
    step_last = calls[-1][2]
    (_, ckc, cvc), (pg, ckg, cvg) = lanes["cpu"], lanes["card"]
    for slot, p in enumerate(prompts):
        rows = len(p) + LM_TICKS
        for got, want in ((ckg, ckc), (cvg, cvc)):
            out["worst"] = max(out["worst"], held(
                got[:, slot, :rows], want[:, slot, :rows], LM_TOL,
                f"9a cache rows of slot {slot}"))
    del lanes, ckc, cvc, ckg, cvg
    ck1, cv1 = init_kv_cache(cfg, 1, mx.gpu(0))
    out["extended"] = 0.0
    for slot, seq in enumerate(seqs):
        seen = np.asarray(seq[:-1])
        logits = pg.prefill(pg.params, ck1, cv1, lm_padded(seen), 0,
                            len(seen))[3]
        out["extended"] = max(out["extended"], held(
            step_last[slot], logits, LM_TOL,
            "9a a step against the prefill of the prompt it had seen"))
    del ck1, cv1, pg
    net = TransformerLM(cfg, prefix="lm_")
    lm_params_from_numpy(params, block=net, ctx=mx.gpu(0))
    net.hybridize()
    fwd = net(mx.nd.array(prompts[-1][None], ctx=mx.gpu(0),
                          dtype="int32")).data[0, -1]
    out["gluon"] = held(prefill_last, fwd, LM_TOL,
                        "9a prefill against the hybridized gluon forward")
    del net, fwd
    cfg16 = LMConfig(**dict(LM_CFG, param_dtype="bfloat16"))
    p16 = DecodePrograms(cfg16, stack_lm_params(
        {k: v.data.to(BF16) for k, v in params.items()}, cfg16, mx.gpu(0)))
    ck16, cv16 = init_kv_cache(cfg16, LM_SLOTS, mx.gpu(0))
    out["bf16_l2"], out["bf16_clear"] = 0.0, 0
    for kind, args, ref in calls:
        _, _, tok, logits = getattr(p16, kind)(p16.params, ck16, cv16, *args)
        l2 = ((logits.float() - ref).norm() / ref.norm()).item()
        out["bf16_l2"] = max(out["bf16_l2"], l2)
        check(l2 <= LM_BF16, f"9a bf16 {kind}: relative L2 {l2:.4f} of "
              f"the fp32 logits above {LM_BF16}")
        clear = lm_clear(ref, LM_BF16)
        out["bf16_clear"] += int(clear.sum())
        check(bool((tok.long() == ref.argmax(-1))[clear].all()),
              f"9a bf16 {kind}: argmax differs at a margin above "
              f"{LM_BF16} of max|logit|")
    del p16, ck16, cv16
    torch.cuda.empty_cache()
    print(f"lm parity: prefills of {'/'.join(map(str, LM_PROMPTS))} tokens "
          f"+ {LM_TICKS} teacher-forced ticks, card vs CPU (fp32): worst "
          f"{out['worst']:.3f} of rtol {LM_TOL[0]} + {LM_TOL[1]}*max|ref| "
          f"(logits and cache rows), argmax equal at every clear margin, "
          f"{out['ties']} near ties of {out['rows']} rows; on the card a "
          f"step vs the prefill of what it had seen {out['extended']:.3f}, "
          f"the prefill vs the hybridized gluon forward "
          f"{out['gluon']:.3f}; bf16 vs fp32 relative L2 at most "
          f"{out['bf16_l2']:.5f} (limit {LM_BF16}), argmax equal at "
          f"{out['bf16_clear']} rows of clear margin [{card}]")
    return out


def lm_trace(vocab):
    """Phase 9b's trace: tools/run_lm_bench.py's `_trace` (seed 17,
    LM_GROUPS groups), then LM_LONG long prompts."""
    rng = np.random.default_rng(17)
    trace = []
    for _ in range(LM_GROUPS):
        for new in [LM_SHORT_NEW] * (LM_SLOTS - 1) + [LM_LONG_NEW]:
            toks = [int(t) for t in rng.integers(1, 60,
                                                 int(rng.integers(2, 9)))]
            trace.append((toks, new))
    rng = np.random.default_rng(SEED + 92)
    for _ in range(LM_LONG):
        n = int(rng.integers(9, LM_BUCKETS[-1] + 1))
        trace.append(([int(t) for t in rng.integers(1, vocab, n)],
                      int(rng.integers(16, 65))))
    return trace


def lm_static(mx, programs, cfg, trace):
    """tools/run_lm_bench.py's static lane (`_static_lane`) through the
    same programs: batches of LM_SLOTS in trace order, each slot
    prefilled into a fresh cache, then every slot stepped until the
    batch's longest budget is spent.  Returns (continuations, whether
    each one's chain is clear of near ties, wall s, ticks)."""
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    conts, clear, ticks = [], [], 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for at in range(0, len(trace), LM_SLOTS):
        batch = trace[at:at + LM_SLOTS]
        ck, cv = init_kv_cache(cfg, LM_SLOTS, mx.gpu(0))
        tokens = np.zeros(LM_SLOTS, np.int32)
        positions = np.zeros(LM_SLOTS, np.int32)
        chains = [[] for _ in batch]
        margins = [[] for _ in batch]
        for s, (toks, _) in enumerate(batch):
            _, _, tok, logits = programs.prefill(
                programs.params, ck, cv, lm_padded(toks), s, len(toks))
            tokens[s], positions[s] = int(tok), len(toks)
            chains[s].append(int(tok))
            margins[s].append(lm_clear(logits, LM_TIE))
        for _ in range(max(new for _, new in batch) - 1):
            _, _, nxt, logits = programs.step(programs.params, ck, cv,
                                              tokens, positions)
            ok = lm_clear(logits, LM_TIE)
            tokens = nxt.cpu().numpy()
            positions += 1
            ticks += 1
            for s in range(len(batch)):
                chains[s].append(int(tokens[s]))
                margins[s].append(ok[s])
        for s, (_, new) in enumerate(batch):
            conts.append(chains[s][:new])
            clear.append(bool(torch.stack(margins[s][:new]).all()))
        del ck, cv
    torch.cuda.synchronize()
    return conts, clear, time.perf_counter() - t0, ticks


def lm_traffic(mx, cfg, params, card, trace):
    """Phase 9b in one dtype: `serving.DecodeEngine` on the card
    (LM_SLOTS slots, LM_BUCKETS), the trace submitted by LM_CLIENTS
    threads at priorities spread over the three classes; every future
    resolves, the continuations equal the static lane's through the same
    programs wherever its chain has no near tie, and no new signature
    appears.  Then the prefill per bucket and the step alone, timed."""
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    from incubator_mxnet_tpu_torch.serving.router import PRIORITIES
    dt = cfg.param_dtype
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = mx.serving.DecodeEngine(cfg, params, slots=LM_SLOTS,
                                  buckets=LM_BUCKETS, name=f"lm-{dt}",
                                  start=False, ctx=mx.gpu(0))
    tick_s = []
    step = eng.step

    def timed_step():
        t = time.perf_counter()
        n = step()
        if n:
            tick_s.append(time.perf_counter() - t)
        return n

    eng.step = timed_step
    programs = eng.warmup()
    check(programs == eng.programs.program_count() == len(LM_BUCKETS) + 1,
          f"9b {dt}: warmup prepared {programs} signatures, expected "
          f"{len(LM_BUCKETS) + 1}")
    eng.start()
    futs = [None] * len(trace)

    def client(k):
        for i in range(k, len(trace), LM_CLIENTS):
            toks, new = trace[i]
            futs[i] = eng.submit(toks, max_new_tokens=new, rid=f"lm-{i}",
                                 priority=PRIORITIES[i % len(PRIORITIES)])

    t0 = time.perf_counter()
    clients = [threading.Thread(target=client, args=(k,))
               for k in range(LM_CLIENTS)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(60)
        check(not t.is_alive(), f"9b {dt}: a client thread hung")
    results = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    stats = eng.stats()
    classes = eng.metrics.snapshot()["classes"]
    eng.close(drain=False)
    got = [r["tokens"] for r in results]
    check([len(g) for g in got] == [new for _, new in trace],
          f"9b {dt}: a continuation is not its budget's length")
    static, clear, static_s, static_ticks = lm_static(mx, eng.programs, cfg,
                                                      trace)
    check(eng.programs.program_count() == programs and
          eng.programs.compile_count() == programs,
          f"9b {dt}: the traffic added a signature")
    bad = [i for i, c in enumerate(clear) if c and static[i] != got[i]]
    check(not bad, f"9b {dt}: sequences {bad} differ from the static lane")
    tied = [(i, static[i] == got[i]) for i, c in enumerate(clear) if not c]
    useful = sum(new for _, new in trace)
    rng = np.random.default_rng(SEED + 94)
    ck, cv = init_kv_cache(cfg, LM_SLOTS, mx.gpu(0))
    prefill_ms = {}
    for b in LM_BUCKETS:
        padded = rng.integers(1, cfg.vocab_size, (1, b)).astype(np.int32)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            eng.programs.prefill(eng.programs.params, ck, cv, padded, 0, b)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        prefill_ms[b] = statistics.median(times[1:])
    tokens = rng.integers(1, cfg.vocab_size, LM_SLOTS).astype(np.int32)
    positions = (np.arange(LM_SLOTS) * 37 + 64).astype(np.int32)
    times = []
    for _ in range(21):
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.programs.step(eng.programs.params, ck, cv, tokens, positions)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    del ck, cv
    out = {
        "tokens_s": useful / wall, "static_tokens_s": useful / static_s,
        "ticks": stats["ticks"], "static_ticks": static_ticks,
        "tick_ms": statistics.median(tick_s) * 1e3,
        "tick_p99_ms": float(np.percentile(tick_s, 99)) * 1e3,
        "step_ms": statistics.median(times[1:]), "prefill_ms": prefill_ms,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "classes": classes, "programs": eng.programs}
    out["ratio"] = out["tokens_s"] / out["static_tokens_s"]
    print(f"lm serve {dt}: {len(trace)} sequences from {LM_CLIENTS} "
          f"clients, {useful} tokens: continuous {out['tokens_s']:.1f} "
          f"tokens/s in {stats['ticks']} ticks ({wall:.2f} s), static "
          f"{out['static_tokens_s']:.1f} tokens/s in {static_ticks} ticks "
          f"({static_s:.2f} s), ratio {out['ratio']:.3f}; every future "
          f"resolved; {len(trace) - len(tied)} continuations equal the "
          f"static lane's, {len(tied)} with a near tie in the chain "
          f"(rid, equal): {tied}; signatures {programs} before and after "
          f"[{card}]")
    print(f"lm serve {dt}: tick median {out['tick_ms']:.3f} ms, p99 "
          f"{out['tick_p99_ms']:.3f} ms; the step alone (8 slots) "
          f"{out['step_ms']:.3f} ms; prefill "
          + ", ".join(f"bucket {b} {ms:.3f} ms"
                      for b, ms in prefill_ms.items())
          + f"; peak {out['peak_gib']:.2f} GiB [{card}]")
    for cls in PRIORITIES:
        c = classes.get(cls, {})
        print(f"lm serve {dt}: {cls}: {c.get('responses')} responses, "
              f"latency p50 {c.get('p50_ms') or 0:.1f} ms p99 "
              f"{c.get('p99_ms') or 0:.1f} ms [{card}]")
    return out


def _device_us(event):
    """Inclusive device time (us) of a profiler CPU event (the name
    changed across torch versions)."""
    if hasattr(event, "device_time_total"):
        return event.device_time_total
    return event.cuda_time_total


def lm_profile(mx, cfg, programs, card, tries=3):
    """Phase 9c, in cfg's dtype: one warm tick under torch.profiler, a
    bucket-256 prefill into slot 0 and a decode step of LM_SLOTS active
    slots: kernels, device ms by class (the inclusive device time of the ops the decode
    plane calls), host ms to enqueue, the device's busy share, and the
    step's bytes bound (parameters and the live cache read once)."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    rng = np.random.default_rng(SEED + 93)
    ck, cv = init_kv_cache(cfg, LM_SLOTS, mx.gpu(0))
    n = LM_BUCKETS[-1] - 16
    prompt = lm_padded(rng.integers(1, cfg.vocab_size, n))
    tokens = rng.integers(1, cfg.vocab_size, LM_SLOTS).astype(np.int32)
    positions = (np.arange(LM_SLOTS) * 37 + n).astype(np.int32)

    def tick():
        programs.prefill(programs.params, ck, cv, prompt, 0, n)
        programs.step(programs.params, ck, cv, tokens, positions)

    tick()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tick()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, f"lm profile {cfg.param_dtype}: the profiler saw no "
          "device activity")
    busy, edge, kernels = 0.0, -math.inf, {}
    for start, end, name in spans:
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
        kernels[name] = kernels.get(name, 0.0) + (end - start)
    device_us = sum(kernels.values())
    by_class, other = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or \
                e.cpu_parent is not None:
            continue
        us = _device_us(e)
        cls = next((label for label, names in LM_OP_CLASSES
                    if e.name in names), "other")
        by_class[cls] = by_class.get(cls, 0.0) + us
        if cls == "other":
            other[e.name] = other.get(e.name, 0.0) + us
    item = ck.element_size()
    p = programs.params
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [p["embed"], p["final_ln_gamma"], p["final_ln_beta"]]
                      + list(p["layers"].values()))
    live = 2 * cfg.num_layers * int((positions + 1).sum()) * cfg.hidden * item
    bound_ms = (param_bytes + live) / HBM_BYTES_S * 1e3
    label = f"lm profile {cfg.param_dtype}"
    print(f"{label}: one warm tick (prefill of {n} tokens in bucket "
          f"{LM_BUCKETS[-1]}, step of {LM_SLOTS} slots at rows "
          f"{positions.min()}-{positions.max()}): {host_ms:.2f} ms of host "
          f"time to enqueue, {wall_ms:.2f} ms to finish, {len(spans)} "
          f"kernels, device time {device_us / 1e3:.3f} ms, device busy "
          f"{busy / 1e3 / wall_ms:.3f}; the step's bytes bound "
          f"{bound_ms:.3f} ms ({param_bytes / 1e9:.3f} GB of parameters + "
          f"{live / 1e9:.3f} GB of live cache at {HBM_BYTES_S / 1e12:.2f} "
          f"TB/s) [{card}]")
    total = sum(by_class.values())
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"{label}: {us / 1e3:9.3f} ms "
              f"{us / total if total else 0.0:6.3f} {cls}")
    for name, us in sorted(other.items(), key=lambda kv: -kv[1])[:4]:
        print(f"{label}: other: {us / 1e3:8.3f} ms {name[:80]}")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:5]:
        print(f"{label}: kernel: {us / 1e3:8.3f} ms {name[:90]}")
    del ck, cv
    return {"busy": busy / 1e3 / wall_ms, "host_ms": host_ms,
            "device_ms": device_us / 1e3, "kernels": len(spans),
            "bound_ms": bound_ms}


def lm_phase(card, workdir):
    """Phase 9; returns the numbers of the summary line.  The counts of
    K1, K2 and K3 are set to 0 before it and must stay 0: no TPU kernel
    is on the LM's serving path."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.llm import LMConfig
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    counted = (fc_relu, flash_fwd, flash_fwd_stream)
    for wrapper in counted:
        wrapper.launches = 0
    cfg = LMConfig(**LM_CFG)
    t0 = time.perf_counter()
    path = os.path.join(workdir, "lm-gpt2-small-widths.params")
    values = lm_values(cfg)
    count = sum(v.size for v in values.values())
    mx.nd.save(path, {k: mx.nd.array(v, ctx=mx.cpu())
                      for k, v in values.items()})
    del values
    params = mx.nd.load(path)
    os.remove(path)
    print(f"lm: {count / 1e6:.2f} M parameters (seed {SEED}) through "
          f"nd.save / nd.load in {time.perf_counter() - t0:.1f} s")
    out = {"parity": lm_parity(mx, cfg, params, card)}
    trace = lm_trace(cfg.vocab_size)
    out["fp32"] = lm_traffic(mx, cfg, params, card, trace)
    out["profile"] = lm_profile(mx, cfg, out["fp32"].pop("programs"), card)
    cfg16 = LMConfig(**dict(LM_CFG, param_dtype="bfloat16"))
    out["bf16"] = lm_traffic(mx, cfg16, {k: v.data.to(BF16)
                                         for k, v in params.items()},
                             card, trace)
    out["profile_bf16"] = lm_profile(mx, cfg16, out["bf16"].pop("programs"),
                                     card)
    launches = [w.launches for w in counted]
    print(f"lm: K1/K2/K3 launches over phase 9: {launches} (no TPU kernel "
          f"is on the LM's serving path)")
    check(launches == [0, 0, 0], "a K1/K2/K3 kernel ran on the LM path")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 10: training the LM at GPT-2 small's widths ------------------------

def lm_opt(batch, t):
    """LM_TRAIN_OPT with the gradient rescaled to the per-token mean."""
    return dict(LM_TRAIN_OPT, rescale_grad=1.0 / (batch * t))


def lm_train_cfg(**kw):
    from incubator_mxnet_tpu_torch.llm import LMConfig
    return LMConfig(**dict(LM_CFG, **kw))


def lm_tokens(mx, batch, t, vocab, ctx, seed):
    """A DataBatch of random next-token pairs: data (batch, t) tokens as
    float32, label the same stream shifted by one."""
    x = np.random.RandomState(seed).randint(1, vocab, (batch, t + 1))
    return mx.io.DataBatch(
        [mx.nd.array(x[:, :-1].astype("f4"), ctx=ctx)],
        [mx.nd.array(x[:, 1:].astype("f4"), ctx=ctx)])


def lm_train_flops(n_params, cfg, batch, t):
    """Operations of one training step: 6 per parameter per token (the
    forward's multiply-add and the backward's two), plus attention's
    Q.K^T and P.V (4 B T^2 C a layer forward, x3 with the backward)."""
    return 6 * n_params * batch * t + \
        3 * cfg.num_layers * 4 * batch * t * t * cfg.hidden


def lm_ce(probs, labels):
    """Mean -log p[label] of one batch's (B*T, V) softmax outputs."""
    p = probs.asnumpy()
    y = labels.asnumpy().reshape(-1).astype(int)
    return float(-np.log(p[np.arange(len(p)), y]).mean())


def lm_train_steps(mx, sym, ctx, batches, dtype, teacher=None, keep=False,
                   after=None):
    """The LM's fused steps (Module.fit_step) in `dtype` on `ctx` from
    Xavier parameters under mx.random.seed(SEED).  Returns the first
    batch's embed_weight gradient at the initial state
    (Module.forward_backward; None with `teacher`), the loss of each
    step, and with `keep` the states ({parameter}, {momentum}) before the
    first step and after each.  With `teacher` (another run's states),
    step k starts from the teacher's state before it; `after(k, state)`
    sees the state after step k."""
    mod = mx.mod.Module(sym, context=ctx)
    batch, t = batches[0].data[0].shape
    mod.bind([("data", (batch, t))], [("softmax_label", (batch, t))])
    if dtype == "float64":
        as_float64(mod)
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer_params=lm_opt(batch, t))
    names = mod._exec_group.param_names

    def state():
        return ({n: v.asnumpy() for n, v in mod.get_params()[0].items()},
                {names[i]: m.asnumpy()
                 for i, m in mod._updater.states.items()})

    grad = None
    if teacher is None:
        mod.forward_backward(batches[0])
        exe = mod._exec_group.execs[0]
        grad = exe.grad_dict["lm_embed_weight"].asnumpy()
    losses, states = [], [state()] if keep else []
    for k, b in enumerate(batches):
        if teacher is not None and k:
            params, moms = teacher[k]
            mod.set_params(params, {})
            for i, n in enumerate(names):
                mod._updater.states[i]._set_data(moms[n])
        mod.fit_step(b, mx.metric.create("acc"))
        losses.append(lm_ce(mod.get_outputs()[0], b.label[0]))
        if keep or after is not None:
            st = state()
            if keep:
                states.append(st)
            if after is not None:
                after(k + 1, st)
    check(mod._fused_step is not None and mod._fused_step.steps ==
          len(batches), f"lm train parity on {ctx}: the fused step did "
          "not run every step")
    del mod
    gc.collect()
    return grad, losses, states


def lm_train_parity(mx, sym, card):
    """Phase 10a: LM_TRAIN_PARITY fused steps of the full-width LM, cut to
    LM_TRAIN_PARITY_LAYERS layers, on the
    card against the CPU from the same Xavier parameters and batches, in
    float64: every step's loss free running; the first batch's
    embed_weight gradient (the lookup's scatter plus the tied head's
    product); and each card step from the CPU's state before it, its
    parameters and momenta within PARITY_TOL.  Then float32 (TF32 off):
    each device's step from the float64 CPU state, the card's relative
    L2 distance from the float64 step at most LM_TRAIN_ENVELOPE times
    the CPU's."""
    batch, t, steps = LM_TRAIN_PARITY
    vocab = LM_CFG["vocab_size"]
    batches = [lm_tokens(mx, batch, t, vocab, mx.cpu(), SEED + 20 + k)
               for k in range(steps)]
    t0 = time.perf_counter()
    g_cpu, cpu_loss, cpu = lm_train_steps(mx, sym, mx.cpu(), batches,
                                          "float64", keep=True)
    t_cpu = time.perf_counter() - t0
    g_card, card_loss, _ = lm_train_steps(mx, sym, mx.gpu(0), batches,
                                          "float64")
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(card_loss, cpu_loss))
    grad = param_ratio({"embed": g_card}, {"embed": g_cpu})[0]
    worst = [(0.0, "none")]

    def hold(k, st):
        for got, ref in zip(st, cpu[k]):
            worst.append(param_ratio(got, ref))
    lm_train_steps(mx, sym, mx.gpu(0), batches, "float64", teacher=cpu,
                   after=hold)
    held_ = max(worst)
    ok = loss_err <= PARITY_TOL[0] and held_[0] <= 1 and grad <= 1
    print(f"lm train parity float64: {steps} fused steps at batch {batch} "
          f"x T {t}, full width, {LM_TRAIN_PARITY_LAYERS} of "
          f"{LM_CFG['num_layers']} layers, card vs CPU (CPU {t_cpu:.1f} s): "
          f"loss "
          f"{' '.join(f'{v:.6f}' for v in card_loss)}; max relative loss "
          f"err {loss_err:.2e} (rtol {PARITY_TOL[0]:g}); embed_weight "
          f"gradient (lookup + tied head) at {grad:.3f} of the tolerance; "
          f"each step from the CPU's state: parameters and momenta at "
          f"{held_[0]:.3f} of the tolerance (worst {held_[1]}) (rtol "
          f"{PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}*max|array|) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "lm train: the card's float64 steps disagree with the CPU's")

    factor, extra = LM_TRAIN_ENVELOPE
    dist = {}

    def l2(device):
        def f(k, st):
            for what, got, ref in zip(("parameters", "momenta"), st,
                                      cpu[k]):
                dist[(device, what, k)] = rel_l2(got, ref, ())
        return f
    losses32 = {}
    for device, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
        _, losses32[device], _ = lm_train_steps(
            mx, sym, ctx, batches, "float32", teacher=cpu, after=l2(device))
    ok, lines = True, []
    for (device, what, k), dc in sorted(dist.items()):
        if device != "cpu":
            continue
        dg = dist[("card", what, k)]
        ok = ok and dg <= factor * dc + extra
        lines.append(f"{what} step {k} {dg:.2e} vs {dc:.2e}")
    loss32 = max(abs(v - c) / abs(c) for run in losses32.values()
                 for v, c in zip(run, cpu_loss))
    ok = ok and loss32 <= PARITY_TOL[0]
    print(f"lm train parity float32, each step from the float64 CPU's "
          f"state: loss within {loss32:.2e} of float64 on both (rtol "
          f"{PARITY_TOL[0]:g}); relative L2 distance from the float64 "
          f"step, card vs CPU: {'; '.join(lines)} (card <= {factor:g} x "
          f"CPU + {extra:g}) {'ok' if ok else 'FAIL'}")
    check(ok, "lm train: the card's float32 steps are farther from float64"
          " than the CPU's")
    del cpu
    gc.collect()
    return {"loss_err": loss_err, "held": held_[0], "grad": grad}


class _SnapshotProbe:
    """Times CheckpointManager.snapshot (the synchronous phase, on the
    host) and each background write (seconds, bytes) while active."""

    def __init__(self):
        from incubator_mxnet_tpu_torch.checkpoint import manager, snapshot
        self._targets = ((manager.CheckpointManager, "snapshot", self.sync),
                         (snapshot.SnapshotJob, "write", self.write))
        self.sync_ms, self.writes = [], []

    def sync(self, orig):
        def f(mgr, *a, **k):
            t0 = time.perf_counter()
            out = orig(mgr, *a, **k)
            self.sync_ms.append((time.perf_counter() - t0) * 1e3)
            return out
        return f

    def write(self, orig):
        def f(job):
            t0 = time.perf_counter()
            orig(job)
            self.writes.append((time.perf_counter() - t0,
                                job.bytes_written, job.seconds))
        return f

    def __enter__(self):
        self._saved = [(cls, name, getattr(cls, name))
                       for cls, name, _ in self._targets]
        for cls, name, wrap in self._targets:
            setattr(cls, name, wrap(getattr(cls, name)))
        return self

    def __exit__(self, *exc):
        for cls, name, orig in self._saved:
            setattr(cls, name, orig)


def lm_train_lane(mx, sym, cfg, card, ckpt_dir=None):
    """Phase 10b: the LM at LM_TRAIN_LANE (8 x 1024 tokens a step, fp32,
    TF32 off) through the public Module.fit on one resident random
    batch, the fused step every step; tokens/s over CUDA-synchronised
    window edges, the median step ms between CUDA events at each batch
    end, the loss of every step (computed on the card), peak memory,
    mfu against the fp32 CUDA-core peak.  With `ckpt_dir`: the same run
    with elastic checkpoints every LM_CKPT_PERIOD batches, and the
    snapshot's synchronous ms, each background write's seconds and
    bytes.  Returns (module, numbers)."""
    batch, t, warm, timed = LM_TRAIN_LANE
    one = lm_tokens(mx, batch, t, cfg.vocab_size, mx.gpu(0), SEED + 30)
    it = resident(mx, one.data[0], one.label[0], warm + timed)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    events, losses, edges = [], [], {}
    ce = mx.metric.create("ce")

    def probe(p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        label = mod._exec_group.execs[0].arg_dict["softmax_label"]
        total, n = ce.device_update([label], mod.get_outputs())
        losses.append(total / n)
        if p.nbatch in (warm - 1, warm + timed - 1):
            torch.cuda.synchronize()
            edges[p.nbatch] = time.perf_counter()
            edges["acc"] = p.eval_metric.get()[1]

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    kw = {} if ckpt_dir is None else dict(
        checkpoint_dir=ckpt_dir, checkpoint_period=LM_CKPT_PERIOD,
        checkpoint_keep_last=2)
    with _SnapshotProbe() as snaps:
        t0 = time.perf_counter()
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=lm_opt(batch, t), eval_metric="acc",
                initializer=mx.initializer.Xavier(),
                batch_end_callback=probe, kvstore=None, **kw)
        wall = time.perf_counter() - t0
    steps = warm + timed
    fused = mod._fused_step
    check(fused is not None and fused.steps == steps,
          f"lm lane: the fused step ran {fused.steps if fused else 0} of "
          f"{steps} steps")
    loss = torch.stack(losses).cpu().numpy()
    tokens_s = batch * t * timed / (edges[warm + timed - 1] -
                                    edges[warm - 1])
    step_ms = [a.elapsed_time(b) for a, b in zip(events[warm - 1:],
                                                 events[warm:])]
    med = statistics.median(step_ms)
    n_params = sum(v.size for v in mod.get_params()[0].values())
    flops = lm_train_flops(n_params, cfg, batch, t)
    mfu = tokens_s * flops / (batch * t) / FP32_CUDA_CORE_FLOPS
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    ok = bool(np.isfinite(loss).all()) and loss[-1] < loss[0]
    what = "no checkpoints" if ckpt_dir is None else \
        f"checkpoints every {LM_CKPT_PERIOD} batches"
    print(f"lm train lane fp32 batch {batch} x T {t} ({what}): {steps} "
          f"steps through Module.fit in {wall:.2f} s ({warm} warm), fused "
          f"step every step; {tokens_s:.1f} tokens/s over the {timed} "
          f"timed steps; step median {med:.3f} ms (p10 "
          f"{np.percentile(step_ms, 10):.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}, CUDA events); "
          f"{n_params / 1e6:.2f} M parameters, {flops / 1e12:.3f} TFLOP a "
          f"step; peak memory {mem:.2f} GiB [{card}]")
    print(f"lm train lane fp32 ({what}): loss first {loss[0]:.4f}, last "
          f"{loss[-1]:.4f}, every {' '.join(f'{v:.3f}' for v in loss[::4])}"
          f"; train acc {edges['acc']:.4f} {'ok' if ok else 'FAIL'}")
    print(f"mfu lm fp32{'' if ckpt_dir is None else ' checkpointed'} "
          f"{mfu:.4f} (of {FP32_CUDA_CORE_FLOPS / 1e12:.0f} TFLOP/s) "
          f"[{card}]")
    check(ok, f"lm lane ({what}): loss not finite or not falling")
    out = {"tokens_s": tokens_s, "step_ms": med, "mfu": mfu,
           "peak_gib": mem, "flops": flops, "n_params": n_params,
           "loss": (float(loss[0]), float(loss[-1]))}
    if ckpt_dir is not None:
        check(snaps.writes and snaps.sync_ms, "lm lane: no snapshot taken")
        secs = [w[0] for w in snaps.writes]
        nbytes = snaps.writes[-1][1]
        parts = {k: statistics.median(w[2][k] for w in snaps.writes)
                 for k in ("wait", "blobs", "write")}
        out.update(sync_ms=statistics.median(snaps.sync_ms),
                   sync_first_ms=snaps.sync_ms[0], write_s=max(secs),
                   write_bytes=nbytes, snapshots=len(snaps.writes),
                   write_parts=parts)
        print(f"lm train lane checkpoints: {len(snaps.writes)} snapshots "
              f"(every {LM_CKPT_PERIOD} batches and the epoch's end); "
              f"the snapshot call on the host median {out['sync_ms']:.2f} "
              f"ms (first {out['sync_first_ms']:.2f} ms, pinned buffers "
              f"allocated; a call waits while the previous write is in "
              f"flight); background write {min(secs):.2f}-{max(secs):.2f} "
              f"s for {nbytes / 1e9:.3f} GB ({nbytes / 1e9 / max(secs):.2f}"
              f" GB/s at the slowest), median parts: copies landing "
              f"{parts['wait']:.3f} s, optimizer blob pickled "
              f"{parts['blobs']:.3f} s, shards written and committed "
              f"{parts['write']:.3f} s [{card}]")
    return mod, out


def lm_component_ms(mx, cfg, card, step_ms):
    """Phase 10d, the parts of a step timed alone at the lane's shapes
    (CUDA events, median of 5 after a warm call): one layer's
    BlockwiseAttention forward and backward (x num_layers), the tied
    head's FullyConnected and SoftmaxOutput forward and backward, and
    the one-hot SoftmaxOutput's backward builds."""
    from incubator_mxnet_tpu_torch.ops import registry
    from incubator_mxnet_tpu_torch.ops.loss_output import _one_hot
    batch, t = LM_TRAIN_LANE[:2]
    c, v = cfg.hidden, cfg.vocab_size
    dev = mx.gpu(0).torch_device
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)

    def rand(*shape):
        return torch.randn(*shape, device=dev, generator=gen,
                           requires_grad=True)

    attn = registry.get("BlockwiseAttention")
    ap = attn.canonicalize_params({"num_heads": cfg.num_heads,
                                   "causal": True})
    fc, so = registry.get("FullyConnected"), registry.get("SoftmaxOutput")
    fp = fc.canonicalize_params({"num_hidden": v, "no_bias": True})
    sp = so.canonicalize_params({})
    q, k, vv = rand(batch, t, c), rand(batch, t, c), rand(batch, t, c)
    h, w = rand(batch * t, c), rand(v, c)
    label = torch.randint(0, v, (batch * t,), device=dev,
                          generator=gen).float()
    ct = torch.randn(batch, t, c, device=dev, generator=gen)

    def attention():
        out = attn.fn(ap, q, k, vv)
        torch.autograd.grad(out, (q, k, vv), ct)

    def head():
        out = so.fn(sp, fc.fn(fp, h, w), label)
        torch.autograd.grad(out, (h, w), torch.ones_like(out))

    def one_hot():
        _one_hot(label.to(torch.int32), v, -1, torch.float32)

    out = {}
    for name, fn in (("attention", attention), ("head", head),
                     ("one_hot", one_hot)):
        fn()
        times = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        out[name] = statistics.median(times)
    attn_ms = out["attention"] * cfg.num_layers
    print(f"lm train parts, alone at batch {batch} x T {t}: attention "
          f"(BlockwiseAttention forward + backward) {out['attention']:.3f} "
          f"ms a layer, {attn_ms:.3f} ms for {cfg.num_layers} "
          f"({attn_ms / step_ms:.3f} of the step); the tied head and "
          f"SoftmaxOutput forward + backward {out['head']:.3f} ms "
          f"({out['head'] / step_ms:.3f}), of which building the "
          f"({batch * t}, {v}) fp32 one-hot {out['one_hot']:.3f} ms "
          f"({out['one_hot'] / step_ms:.3f}) [{card}]")
    del q, k, vv, h, w, ct
    torch.cuda.empty_cache()
    return dict(out, attention_all=attn_ms)



def lm_resume_child(mode, ckpt_dir, out_path):
    """Phase 10c's child process (`python -c`): the reduced-depth LM
    (LM_RESUME) through Module.fit on the card under
    torch.use_deterministic_algorithms(True), from Xavier under one
    seed, over a shuffled NDArrayIter.  `mode`: "full" (no
    checkpoints), "kill" (SIGKILL itself once batch kill_after is done),
    "term" (waits at batch term_after for SIGTERM, whose hook takes the
    final snapshot and exits 143), "resume" (resume=True).  Prints
    "STEP n" after each batch; writes the sha256 of every parameter's
    and momentum's bytes to `out_path`."""
    import hashlib
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.llm import lm_symbol
    r = LM_RESUME
    cfg = lm_train_cfg(num_layers=r["layers"])
    n = r["batch"] * r["batches"]
    x = np.random.RandomState(SEED + 50).randint(
        1, cfg.vocab_size, (n, r["t"] + 1))
    mx.random.seed(SEED)
    np.random.seed(SEED)     # NDArrayIter shuffles with numpy's generator
    it = mx.io.NDArrayIter(x[:, :-1].astype("f4"), x[:, 1:].astype("f4"),
                           batch_size=r["batch"], shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.Module(lm_symbol(cfg), context=mx.gpu(0))
    done = {"n": 0}

    def cb(p):
        done["n"] += 1
        step = p.epoch * r["batches"] + p.nbatch + 1
        print(f"STEP {step}", flush=True)
        if mode == "kill" and step == r["kill_after"]:
            torch.cuda.synchronize()
            os.kill(os.getpid(), signal.SIGKILL)
        if mode == "term" and step == r["term_after"]:
            mgr = p.locals["ckpt_mgr"]
            deadline = time.time() + 120
            while not mgr.preempt_requested and time.time() < deadline:
                time.sleep(0.02)

    mod.fit(it, num_epoch=r["epochs"], optimizer="sgd",
            optimizer_params=lm_opt(r["batch"], r["t"]), eval_metric="acc",
            initializer=mx.initializer.Xavier(),
            checkpoint_dir=None if mode == "full" else ckpt_dir,
            checkpoint_period=r["period"], checkpoint_keep_last=2,
            resume=mode == "resume", batch_end_callback=cb, kvstore=None)
    names = mod._exec_group.param_names

    def digest(a):
        return hashlib.sha256(a.data.detach().contiguous().cpu().numpy()
                              .tobytes()).hexdigest()
    out = {"param:" + k: digest(v)
           for k, v in mod.get_params()[0].items()}
    out.update({"momentum:" + names[i]: digest(s)
                for i, s in mod._updater.states.items()})
    out["num_update"] = mod._optimizer.num_update
    out["batches_run"] = done["n"]
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def lm_resume(card, workdir):
    """Phase 10c: bitwise resume on the card across processes.  Three
    children at once: an uninterrupted fit, a fit SIGKILLed after batch
    kill_after, and a fit sent SIGTERM at batch term_after (it must exit
    143 and leave a valid snapshot marked preempted); then two children
    resume from those directories.  Every parameter and momentum of each
    resumed fit must equal the uninterrupted fit's bit for bit."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    r = LM_RESUME
    env = dict(os.environ, **LM_RESUME_ENV)
    root = tempfile.mkdtemp(dir=workdir, prefix="lm-resume-")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.lm_resume_child(*sys.argv[1:]))")
    procs = {}

    def spawn(name, mode, d):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code, mode, d,
             os.path.join(root, name + ".json")], cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(name, timeout=600):
        out, err = procs[name].communicate(timeout=timeout)
        return procs[name].returncode, out, err

    kill_dir, term_dir = (os.path.join(root, "kill"),
                          os.path.join(root, "term"))
    t0 = time.perf_counter()
    try:
        spawn("full", "full", "-")
        spawn("kill", "kill", kill_dir)
        spawn("term", "term", term_dir)
        term = procs["term"]
        seen = []
        for line in term.stdout:
            seen.append(line)
            if line.strip() == f"STEP {r['term_after']}":
                term.send_signal(signal.SIGTERM)
                break
        codes = {name: finish(name) for name in ("full", "kill", "term")}
        codes["term"] = (codes["term"][0], "".join(seen) + codes["term"][1],
                         codes["term"][2])
        for name, want in (("full", 0), ("kill", -signal.SIGKILL),
                           ("term", 143)):
            rc, out, err = codes[name]
            check(rc == want, f"10c {name}: exit {rc}, expected {want}: "
                  f"{out[-800:]} {err[-2000:]}")
        for d in (kill_dir, term_dir):
            check(ckpt.latest(d) is not None, f"10c: no valid snapshot in "
                  f"{d}")
        last_kill = ckpt.load(ckpt.latest(kill_dir))
        last_term = ckpt.load(ckpt.latest(term_dir))
        check(last_term.meta.get("preempted") is True and
              last_term.step == r["term_after"],
              f"10c: SIGTERM's snapshot is step {last_term.step}, meta "
              f"{last_term.meta}")
        t1 = time.perf_counter()
        spawn("resume_kill", "resume", kill_dir)
        spawn("resume_term", "resume", term_dir)
        for name in ("resume_kill", "resume_term"):
            rc, out, err = finish(name)
            check(rc == 0, f"10c {name}: exit {rc}: {err[-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for name in ("full", "resume_kill", "resume_term"):
        with open(os.path.join(root, name + ".json")) as f:
            res[name] = json.load(f)
    total = r["batches"] * r["epochs"]
    check(res["full"]["num_update"] == total, "10c: the full fit ran "
          f"{res['full']['num_update']} updates")
    arrays = [k for k in res["full"] if ":" in k]
    for name in ("resume_kill", "resume_term"):
        diff = [k for k in arrays if res[name][k] != res["full"][k]]
        check(not diff and res[name]["num_update"] == total,
              f"10c {name}: {len(diff)} of {len(arrays)} arrays differ "
              f"from the uninterrupted fit bitwise ({diff[:4]})")
    shutil.rmtree(root, ignore_errors=True)
    print(f"lm resume: {r['layers']} layers at width "
          f"{LM_CFG['hidden']} (vocab {LM_CFG['vocab_size']}), batch "
          f"{r['batch']} x {r['t']}, {r['epochs']} epochs of "
          f"{r['batches']} shuffled batches, snapshots every "
          f"{r['period']} batches, deterministic algorithms "
          f"({LM_RESUME_ENV}): SIGKILL after batch {r['kill_after']} "
          f"(newest valid snapshot: step {last_kill.step}), resumed for "
          f"{res['resume_kill']['batches_run']} batches; SIGTERM at batch "
          f"{r['term_after']}: exit 143, final snapshot step "
          f"{last_term.step} marked preempted, resumed for "
          f"{res['resume_term']['batches_run']} batches; {len(arrays)} "
          f"parameters and momenta of both resumed fits equal the "
          f"uninterrupted fit's bitwise; children {t1 - t0:.1f} s + "
          f"{time.perf_counter() - t1:.1f} s [{card}]")
    return {"kill_step": last_kill.step, "arrays": len(arrays)}


def lm_serve_trained(mx, cfg, mod, ckpt_dir, card):
    """Phase 10e: the newest checkpoint of the checkpointed lane loaded
    (`checkpoint.load`, `compat.weights.lm_params_from_numpy`) into
    `serving.DecodeEngine`; prefills of three prompts held to the
    trained Module's forward at each prompt's last position (the log
    softmax, centred), and one greedy token each through the engine
    equal to the Module's argmax where its margin is clear."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch.compat.weights import lm_params_from_numpy
    from incubator_mxnet_tpu_torch.llm import init_kv_cache
    data = ckpt.load(ckpt.latest(ckpt_dir))
    params = lm_params_from_numpy(data.arrays, ctx=mx.gpu(0))
    trained = mod.get_params()[0]
    check(all(np.array_equal(params[k].asnumpy(), v.asnumpy())
              for k, v in trained.items()),
          "10e: the newest checkpoint is not the trained parameters")
    batch, t = LM_TRAIN_LANE[:2]
    rng = np.random.default_rng(SEED + 60)
    prompts = [rng.integers(1, cfg.vocab_size, n) for n in LM_PROMPTS]
    x = np.zeros((batch, t), np.float32)
    for i, p in enumerate(prompts):
        x[i, :len(p)] = p
    mod.forward(mx.io.DataBatch([mx.nd.array(x, ctx=mx.gpu(0))],
                                [mx.nd.zeros((batch, t), ctx=mx.gpu(0))]),
                is_train=False)
    probs = mod.get_outputs()[0].data.reshape(batch, t, -1)
    eng = mx.serving.DecodeEngine(cfg, params, slots=4, buckets=LM_BUCKETS,
                                  name="lm-trained", ctx=mx.gpu(0))
    worst = 0.0
    try:
        progs = eng.programs
        ck, cv = init_kv_cache(cfg, 1, mx.gpu(0))
        futs = [eng.submit(p, max_new_tokens=1) for p in prompts]
        toks = [f.result(300)["tokens"][0] for f in futs]
        clear = 0
        for i, p in enumerate(prompts):
            logits = progs.prefill(progs.params, ck, cv, lm_padded(p), 0,
                                   len(p))[3].float().reshape(-1)
            got = torch.log_softmax(logits, -1)
            want = torch.log(probs[i, len(p) - 1].float() + 1e-30)
            worst = max(worst, held(got - got.mean(), want - want.mean(),
                                    LM_TOL, f"10e prefill of {len(p)}"))
            if bool(lm_clear(want[None], LM_TIE)[0]):
                clear += 1
                check(toks[i] == int(want.argmax()),
                      f"10e: greedy token {toks[i]} vs the Module's "
                      f"{int(want.argmax())}")
    finally:
        eng.close(drain=True)
    print(f"lm serve trained: the checkpoint of step {data.step} (equal "
          f"to the trained parameters) in DecodeEngine; prefills of "
          f"{'/'.join(map(str, LM_PROMPTS))} tokens vs the trained "
          f"Module's forward: worst {worst:.3f} of rtol {LM_TOL[0]} + "
          f"{LM_TOL[1]}*max|ref| (log softmax), greedy token equal at "
          f"{clear} of {len(prompts)} clear margins [{card}]")
    return worst


def lm_train_phase(card, workdir):
    """Phase 10; returns the numbers of the summary line.  The counts of
    K1, K2 and K3 are set to 0 before it and must stay 0: no TPU kernel
    is on the LM's training path."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.llm import lm_symbol
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    counted = (fc_relu, flash_fwd, flash_fwd_stream)
    for wrapper in counted:
        wrapper.launches = 0
    cfg = lm_train_cfg()
    sym = lm_symbol(cfg)
    out = {}
    t0 = time.perf_counter()
    out["parity"] = lm_train_parity(
        mx, lm_symbol(lm_train_cfg(num_layers=LM_TRAIN_PARITY_LAYERS)),
        card)
    print(f"phase 10a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mod, out["lane"] = lm_train_lane(mx, sym, cfg, card)
    one = lm_tokens(mx, *LM_TRAIN_LANE[:2], cfg.vocab_size, mx.gpu(0),
                    SEED + 31)
    metric = mx.metric.create("acc")
    prof = profile_one_step(lambda: mod.fit_step(one, metric), card,
                            "lm train profile", LM_TRAIN_LANE[0],
                            dtype="fp32", classes=LM_TRAIN_CLASSES)
    out["profile"] = prof
    out["parts"] = lm_component_ms(mx, cfg, card, out["lane"]["step_ms"])
    del mod
    ckpt_dir = tempfile.mkdtemp(dir=workdir, prefix="lm-ckpt-")
    try:
        mod, out["ckpt"] = lm_train_lane(mx, sym, cfg, card,
                                         ckpt_dir=ckpt_dir)
        out["ckpt"]["slowdown"] = out["ckpt"]["step_ms"] / \
            out["lane"]["step_ms"]
        print(f"lm train lane: checkpointed step median "
              f"{out['ckpt']['step_ms']:.3f} ms vs {out['lane']['step_ms']:.3f}"
              f" ms without ({out['ckpt']['slowdown']:.3f}x); tokens/s "
              f"{out['ckpt']['tokens_s']:.1f} vs {out['lane']['tokens_s']:.1f}"
              f" [{card}]")
        out["serve"] = lm_serve_trained(mx, cfg, mod, ckpt_dir, card)
        del mod
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10b/d/e: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["resume"] = lm_resume(card, workdir)
    print(f"phase 10c: {time.perf_counter() - t0:.1f} s")
    launches = [w.launches for w in counted]
    print(f"lm train: K1/K2/K3 launches over phase 10: {launches} (no TPU "
          f"kernel is on the LM's training path)")
    check(launches == [0, 0, 0], "a K1/K2/K3 kernel ran on the LM "
          "training path")
    return out


# ---------------------------------------------------------------------------
# Phase 11: BASELINE config #4, the bucketed LSTM language model
# ---------------------------------------------------------------------------

def lstm_corpus(cfg, seed=SEED):
    """lstm_bucketing.py:31-40 `synthetic_corpus`: a power-law token
    stream, sentence lengths in [8, 60), from the example's
    RandomState(0)."""
    rng = np.random.RandomState(seed)
    probs = 1.0 / np.arange(1, cfg["vocab"] + 1)
    probs /= probs.sum()
    out = []
    for _ in range(cfg["sentences"]):
        length = int(rng.randint(8, 60))
        out.append(rng.choice(cfg["vocab"], size=length, p=probs).tolist())
    return out


def lstm_sym_gen(mx, cfg, fused=False):
    """lstm_bucketing.py's `sym_gen` over its stack (`--fused`: one
    FusedRNNCell, the RNN op)."""
    if fused:
        stack = mx.rnn.FusedRNNCell(cfg["hidden"], num_layers=cfg["layers"],
                                    mode="lstm")
    else:
        stack = mx.rnn.SequentialRNNCell()
        for i in range(cfg["layers"]):
            stack.add(mx.rnn.LSTMCell(cfg["hidden"], prefix=f"lstm_l{i}_"))

    def sym_gen(seq_len):
        data = mx.sym.Variable("data")
        label = mx.sym.Variable("softmax_label")
        embed = mx.sym.Embedding(data, input_dim=cfg["vocab"],
                                 output_dim=cfg["embed"], name="embed")
        stack.reset()
        outputs, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.Reshape(outputs, shape=(-1, cfg["hidden"]))
        pred = mx.sym.FullyConnected(pred, num_hidden=cfg["vocab"],
                                     name="pred")
        lab = mx.sym.Reshape(label, shape=(-1,))
        pred = mx.sym.SoftmaxOutput(pred, lab, name="softmax")
        return pred, ("data",), ("softmax_label",)
    return sym_gen


def lstm_iter(mx, corpus, cfg):
    """The example's BucketSentenceIter (invalid_label 0); its shuffles
    draw from Python's and numpy's global streams, seeded here."""
    random.seed(SEED)
    np.random.seed(SEED)
    return mx.rnn.BucketSentenceIter(corpus, cfg["batch"],
                                     buckets=list(cfg["buckets"]),
                                     invalid_label=0)


def lstm_module(mx, cfg, ctx, values=None, opt=None, fused=False,
                optimizer="sgd", f64=False):
    """A BucketingModule of the example's sym_gen bound at the default
    bucket, its parameters from `values` (numpy, through compat.weights)
    or the example's Xavier under mx.random.seed(SEED), `optimizer`
    with `opt`; with `f64` the default bucket's arrays in float64
    (`opt15_module` turns the other buckets')."""
    from incubator_mxnet_tpu_torch.compat import weights
    key = max(cfg["buckets"])
    mod = mx.mod.BucketingModule(lstm_sym_gen(mx, cfg, fused),
                                 default_bucket_key=key, context=ctx)
    shape = (cfg["batch"], key)
    mod.bind([mx.io.DataDesc("data", shape)],
             [mx.io.DataDesc("softmax_label", shape)])
    if f64:
        as_float64(mod._buckets[key])
    mx.random.seed(SEED)
    if values is None:
        mod.init_params(initializer=lstm_init(mx))
    else:
        mod.init_params(arg_params=weights.params_from_numpy(
            values, ctx=mx.cpu())[0])
    mod.init_optimizer(optimizer=optimizer,
                       optimizer_params=dict(opt or LSTM_OPT))
    return mod


def lstm_state(mx, mod):
    """Every bucket's parameters (each bucket's own begin states
    included) and the default bucket's optimizer states, as numpy:
    {name or ("state", parameter name, k): array} (k: the state's place
    in a tuple state)."""
    from incubator_mxnet_tpu_torch.compat import weights
    default = mod._buckets[mod._default_bucket_key]
    names = default._exec_group.param_names
    state = weights.bucketing_params_to_numpy(mod)
    for i, s in weights.module_states_to_numpy(default).items():
        for k, v in enumerate(s if isinstance(s, tuple) else (s,)):
            if v is not None:
                state[("state", names[i], k)] = v
    return state


def lstm_set_state(mx, mod, state):
    """Write `state` (as `lstm_state` gives it) into every bucket's
    parameters and the optimizer states that exist."""
    from incubator_mxnet_tpu_torch.compat import weights
    default = mod._buckets[mod._default_bucket_key]
    names = default._exec_group.param_names
    weights.bucketing_params_from_numpy(
        mod, {k: v for k, v in state.items() if isinstance(k, str)})
    for i, s in default._updater.states.items():
        for k, arr in enumerate(s if isinstance(s, tuple) else (s,)):
            if arr is not None:
                arr._set_data(torch.from_numpy(state[("state", names[i],
                                                      k)]))


def lstm_ratio(got, ref, tol=PARITY_TOL):
    """(worst |got - ref| / (rtol |ref| + atol max|ref|), its name) over
    the arrays of `ref`; at most 1 passes."""
    rtol, atol = tol
    worst = (0.0, "none")
    for name, want in ref.items():
        want = np.asarray(want, np.float64)
        bound = np.maximum(rtol * np.abs(want) + atol * np.abs(want).max(),
                           1e-30)
        r = float((np.abs(np.asarray(got[name], np.float64) - want) /
                   bound).max())
        worst = max(worst, (r, str(name)))
    return worst


def lstm_loss(mod, batch):
    """The step's mean -log p(label) over the labels that are not padding
    (Perplexity(0)'s quantity), from the module's outputs."""
    probs = mod.get_outputs()[0].data.double()
    lab = batch.label[0].data.to(probs.device).reshape(-1).long()
    p = probs.gather(1, lab[:, None])[:, 0].clamp_min(1e-10)
    keep = lab != 0
    return float((-p.log() * keep).sum() / keep.sum())


def lstm_parity(mx, cfg, corpus, card):
    """Phase 11a: LSTM_PARITY_KEYS' steps (a batch of each listed bucket,
    in that order) through the fused step of every bucket, card against
    the port on the CPU from the same parameters (the example's Xavier,
    bitwise the JAX package's under one seed, carried as numpy by
    compat.weights) and batches, fp32, TF32 off; free running and each
    step from the CPU's state.  SGD with momentum, so the shared momenta
    are held too."""
    pool = {}
    for b in lstm_iter(mx, corpus, cfg):
        pool.setdefault(b.bucket_key, []).append(b)
    batches = [pool[k].pop(0) for k in LSTM_PARITY_KEYS]
    values = lstm_state(mx, lstm_module(mx, cfg, mx.cpu()))
    opt = dict(LSTM_OPT, momentum=LSTM_PARITY_MOMENTUM)
    runs = {}
    for name, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0)),
                      ("teacher", mx.gpu(0))):
        mod = lstm_module(mx, cfg, ctx, values, opt)
        metric = mx.metric.Perplexity(0)
        losses, states, ratios = [], [], []
        for k, b in enumerate(batches):
            if name == "teacher":
                mod.switch_bucket(b.bucket_key, b.provide_data,
                                  b.provide_label)
                lstm_set_state(mx, mod, runs["cpu"][1][k - 1] if k
                               else values)
            mod.fit_step(b, metric)
            losses.append(lstm_loss(mod, b))
            if name != "card" or k == len(batches) - 1:
                states.append(lstm_state(mx, mod))
            if name == "teacher":
                ratios.append(lstm_ratio(states[-1], runs["cpu"][1][k]))
        steps = {key: m._fused_step.steps for key, m in mod._buckets.items()}
        check(sum(steps.values()) == len(batches), f"11a {name}: the fused "
              f"step declined a batch ({steps})")
        runs[name] = (losses, states, ratios)
    cpu_losses, cpu_states, _ = runs["cpu"]
    held_worst, loss_worst = 0.0, 0.0
    for name in ("card", "teacher"):
        losses, states, ratios = runs[name]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                         cpu_losses))
        check(loss_err <= PARITY_TOL[0], f"11a {name}: loss rel err "
              f"{loss_err:.3g}")
        if name == "card":
            ratios = [lstm_ratio(states[-1], cpu_states[-1])]
        worst = max(ratios)
        print(f"lstm parity: {name}: {len(batches)} steps (buckets "
              f"{'/'.join(map(str, LSTM_PARITY_KEYS))}), losses "
              f"{' '.join(f'{x:.6f}' for x in losses)} (cpu "
              f"{' '.join(f'{x:.6f}' for x in cpu_losses)}), loss rel err "
              f"{loss_err:.3g}; parameters, begin states and momenta "
              f"worst {worst[0]:.4f} of the tolerance ({worst[1]}) [{card}]")
        check(worst[0] <= 1.0, f"11a {name}: {worst[1]} off by "
              f"{worst[0]:.3f} of the tolerance")
        held_worst = max(held_worst, worst[0])
        loss_worst = max(loss_worst, loss_err)
    return {"worst": held_worst, "loss_err": loss_worst,
            "losses": cpu_losses}


def lstm_rnn_op(mx, cfg, card):
    """Phase 11b: the RNN op as FusedRNNCell runs it at the config's
    widths (bucket 60: T 60, batch 32, 2 layers of 200 over embed 200):
    the card's route (cuDNN, `ops.nn.rnn_cudnn`) against the plain loop
    (`rnn_plain`) on the card, fp32, forward and the gradient of every
    input under a random cotangent; both timed; then one fused-cell
    BucketingModule step at bucket 60, counted on the cuDNN route."""
    from incubator_mxnet_tpu_torch.ops import nn as ops_nn
    T, B, H, L = max(cfg["buckets"]), cfg["batch"], cfg["hidden"], \
        cfg["layers"]
    rng = np.random.RandomState(SEED + 11)
    n = ops_nn.rnn_param_size("lstm", cfg["embed"], H, L, False)
    scale = math.sqrt(2.34 / H)
    vals = [rng.uniform(-1, 1, (T, B, cfg["embed"])),
            rng.uniform(-scale, scale, n), rng.uniform(-1, 1, (L, B, H)),
            rng.uniform(-1, 1, (L, B, H))]
    cots = [rng.normal(0, 1, s) for s in ((T, B, H), (L, B, H), (L, B, H))]
    params = {"mode": "lstm", "num_layers": L, "state_size": H,
              "bidirectional": False, "p": 0.0, "_train": True}
    dev = mx.gpu(0).torch_device
    cuda = [torch.tensor(c, dtype=torch.float32, device=dev) for c in cots]
    results, times = {}, {}
    for name, route in (("cudnn", ops_nn.rnn_cudnn),
                        ("plain", ops_nn.rnn_plain)):
        ins = [torch.tensor(v, dtype=torch.float32, device=dev,
                            requires_grad=True) for v in vals]

        def run():
            outs = route(params, *ins)
            loss = sum((o * c).sum() for o, c in zip(outs, cuda))
            return outs, torch.autograd.grad(loss, ins)

        outs, grads = run()
        results[name] = [o.detach() for o in outs] + list(grads)
        # the recurrence re-reads its 0.64 M weights every step: no flush
        times[name] = time_ms(run, torch.empty(0, device=dev), iters=5)
    worst = max(held(g, r, PARITY_TOL, f"11b {what}")
                for g, r, what in zip(results["cudnn"], results["plain"],
                                      ("out", "h_n", "c_n", "d data",
                                       "d parameters", "d state",
                                       "d state_cell")))
    print(f"lstm rnn op: T {T} batch {B} 2x{H} fp32, cuDNN route against "
          f"the plain loop on the card: output, states and the gradients "
          f"of data, parameters, state, state_cell worst {worst:.4f} of "
          f"the tolerance; forward+backward {times['cudnn']:.3f} ms "
          f"(plain loop {times['plain']:.3f} ms) [{card}]")
    before = dict(ops_nn.rnn_routes)
    mod = lstm_module(mx, cfg, mx.gpu(0), fused=True)
    it = lstm_iter(mx, lstm_corpus(cfg), cfg)
    batch = next(b for b in it if b.bucket_key == T)
    metric = mx.metric.Perplexity(0)
    mod.fit_step(batch, metric)
    loss = lstm_loss(mod, batch)
    routes = {k: ops_nn.rnn_routes[k] - before[k] for k in before}
    check(routes == {"cudnn": 1, "plain": 0}, f"11b: the fused cell's "
          f"step took routes {routes}")
    check(mod._curr_module._fused_step.steps == 1, "11b: the fused cell's "
          "step did not run the fused train step")
    check(math.isfinite(loss), "11b: the fused cell's loss is not finite")
    print(f"lstm rnn op: FusedRNNCell (--fused) BucketingModule step at "
          f"bucket {T}: RNN op routes {routes}, loss {loss:.4f} [{card}]")
    return {"worst": worst, "ms": times["cudnn"],
            "plain_ms": times["plain"]}


def lstm_bucket_lane(mx, cfg, corpus, card):
    """Phase 11c, config #4: `BucketingModule.fit` over one epoch of the
    corpus on the card, the example's optimizer and initializer, each
    batch's end synchronised and timed: tokens/s (every position of the
    padded batches, and the words alone) over the steps that are not a
    bucket's first (that one binds the bucket), the median step ms per
    bucket, peak memory, batches the fused step declined, perplexity."""
    it = lstm_iter(mx, corpus, cfg)
    mod = mx.mod.BucketingModule(lstm_sym_gen(mx, cfg),
                                 default_bucket_key=it.default_bucket_key,
                                 context=mx.gpu(0))
    rows, curve = [], []
    last = [None]

    def on_batch(p):
        torch.cuda.synchronize()
        now = time.perf_counter()
        batch = p.locals["data_batch"]
        words = int((batch.data[0].asnumpy() != 0).sum())
        rows.append((mod._curr_bucket_key, now - last[0], words))
        curve.append(p.eval_metric.get()[1])
        last[0] = time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    t0 = last[0] = time.perf_counter()
    mod.fit(it, eval_metric=mx.metric.Perplexity(0), optimizer="sgd",
            optimizer_params=dict(LSTM_OPT), initializer=lstm_init(mx),
            num_epoch=1, batch_end_callback=on_batch)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    seen, steady = set(), []
    for key, dt, words in rows:
        if key in seen:
            steady.append((key, dt, words))
        seen.add(key)
    B = cfg["batch"]
    step_ms = {k: statistics.median(dt for kk, dt, _ in steady if kk == k)
               * 1e3 for k in sorted({k for k, _, _ in steady})}
    tokens_s = sum(B * k for k, _, _ in steady) / sum(dt for _, dt, _ in
                                                       steady)
    words_s = sum(w for _, _, w in steady) / sum(dt for _, dt, _ in steady)
    fused = sum(m._fused_step.steps for m in mod._buckets.values())
    declined = len(rows) - fused
    out = {"tokens_s": tokens_s, "words_s": words_s, "step_ms": step_ms,
           "peak_gib": peak, "declined": declined, "batches": len(rows),
           "wall_s": wall, "ppl_first": curve[0], "ppl_last": curve[-1],
           "epoch_tokens_s": sum(B * k for k, _, _ in rows) / wall}
    print(f"lstm bucket lane: BucketingModule.fit, config #4, one epoch: "
          f"{len(rows)} batches in {wall:.2f} s ({out['epoch_tokens_s']:.1f}"
          f" tokens/s with binds), steady {tokens_s:.1f} tokens/s "
          f"({words_s:.1f} words/s); step ms by bucket "
          + ", ".join(f"{k}: {v:.2f}" for k, v in step_ms.items())
          + f"; peak {peak:.2f} GiB; fused step declined {declined}; "
          f"perplexity {curve[0]:.1f} after the first batch, "
          f"{curve[-1]:.1f} over the epoch [{card}]")
    check(declined == 0, f"11c: the fused step declined {declined} batches")
    check(all(math.isfinite(v) for v in curve), "11c: perplexity not finite")
    check(curve[-1] < curve[0], "11c: perplexity did not fall")
    return mod, out


def lstm_fixed_lane(mx, cfg, card):
    """Phase 11c, bench.py's LSTM lane (:290-375): `_lstm_symbol` at a
    fixed 35 steps through `Module.fit` on one resident random batch
    (SGD lr 0.1, momentum 0.9, Perplexity(0), Xavier in/2.34), the fused
    step every step; a CUDA-synchronised window of timed steps after the
    warm ones: tokens/s, step ms, peak memory, perplexity."""
    seq, warm, timed = (LSTM_FIXED[k] for k in ("seq", "warm", "timed"))
    B = cfg["batch"]
    sym, _, _ = lstm_sym_gen(mx, cfg)(seq)
    n_scan = sum(1 for n in sym._topo()
                 if not n.is_variable and n.op.name == "_foreach")
    check(n_scan == 1, "the LSTM lane's graph must hold ONE _foreach")
    rng = np.random.RandomState(SEED)
    data = mx.nd.array(rng.randint(0, cfg["vocab"], (B, seq)), ctx=mx.cpu())
    label = mx.nd.array(rng.randint(0, cfg["vocab"], (B, seq)),
                        ctx=mx.cpu())
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    marks, curve = {}, []

    def on_batch(p):
        if p.nbatch in (warm - 1, warm + timed - 1):
            torch.cuda.synchronize()
            marks[p.nbatch] = time.perf_counter()
        curve.append(p.eval_metric.get()[1])

    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    mod.fit(resident(mx, data, label, warm + timed), num_epoch=1,
            optimizer="sgd", optimizer_params=dict(LSTM_FIXED_OPT),
            eval_metric=mx.metric.Perplexity(0), initializer=lstm_init(mx),
            batch_end_callback=on_batch)
    dt = marks[warm + timed - 1] - marks[warm - 1]
    out = {"tokens_s": timed * B * seq / dt, "step_ms": dt / timed * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "declined": warm + timed - mod._fused_step.steps,
           "ppl_first": curve[0], "ppl_last": curve[-1]}
    print(f"lstm fixed lane: bench.py's LSTM lane (Module.fit, T {seq}, "
          f"batch {B}): {out['tokens_s']:.1f} tokens/s, step "
          f"{out['step_ms']:.3f} ms, peak {out['peak_gib']:.2f} GiB, fused "
          f"step declined {out['declined']}, perplexity {curve[0]:.1f} -> "
          f"{curve[-1]:.1f} [{card}]")
    check(out["declined"] == 0, "11c: the fixed lane's fused step declined")
    check(all(math.isfinite(v) for v in curve) and curve[-1] < curve[0],
          "11c: the fixed lane's perplexity is not finite and falling")
    return out


def lstm_control_flow(mx, card):
    """Phase 11e: `_while_loop` (padded outputs; and without outputs,
    stopping at the first false condition) and `_cond` on both branches,
    forward and gradients, card against CPU at a small size."""
    s = mx.sym
    i, v, w = s.Variable("i"), s.Variable("v"), s.Variable("w")
    padded, pfin = s.contrib.while_loop(
        cond=lambda i, v: i < 4,
        func=lambda i, v: ([s.tanh(s.broadcast_mul(v, w)) * i],
                           [i + 1, v + i]),
        loop_vars=[i, v], max_iterations=7)
    _, early = s.contrib.while_loop(
        cond=lambda i, v: i < 4, func=lambda i, v: ([], [i + 1, v * 2.0]),
        loop_vars=[i, v], max_iterations=1_000_000)
    c = s.contrib.cond(s.sum(v) > 1.0, lambda: s.exp(v) * w,
                       lambda: v - w)
    graph = s.Group([s.sum(padded[0]), pfin[1]] + list(early) + [c])
    worst = 0.0
    for vv in (0.3, 1.7):
        res = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            args = {"i": mx.nd.array([0.0], ctx=ctx),
                    "v": mx.nd.array([vv / 3] * 3, ctx=ctx),
                    "w": mx.nd.array([0.5, -1.0, 2.0], ctx=ctx)}
            grads = {k: mx.nd.zeros((3,), ctx=ctx) for k in ("v", "w")}
            ex = graph.bind(ctx, args, args_grad=grads)
            outs = [o.data.cpu() for o in ex.forward(is_train=True)]
            ex.backward([mx.nd.ones(o.shape, ctx=ctx) for o in ex.outputs])
            res.append(outs + [g.data.cpu() for g in grads.values()])
        check(res[0][2].item() == 4.0, "11e: the early-stopping loop ran "
              f"{res[0][2].item()} iterations, not 4")
        for got, ref in zip(res[1], res[0]):
            worst = max(worst, held(got, ref, (1e-5, 1e-6), "11e"))
    print(f"lstm control flow: _while_loop (padded to 7; no outputs, "
          f"1,000,000 max iterations, stopped at 4) and _cond (both "
          f"branches), outputs and gradients card against CPU: worst "
          f"{worst:.4f} of rtol 1e-5 + 1e-6*max [{card}]")
    return worst


def lstm_phase(card):
    """Phase 11; returns the numbers of the summary line.  The counts of
    K1, K2 and K3 are set to 0 before it and must stay 0: no TPU kernel
    is on the LSTM's paths."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    counted = (fc_relu, flash_fwd, flash_fwd_stream)
    for wrapper in counted:
        wrapper.launches = 0
    cfg = LSTM_CFG
    corpus = lstm_corpus(cfg)
    out = {}
    t0 = time.perf_counter()
    out["parity"] = lstm_parity(mx, cfg, corpus, card)
    print(f"phase 11a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["rnn"] = lstm_rnn_op(mx, cfg, card)
    print(f"phase 11b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mod, out["bucket"] = lstm_bucket_lane(mx, cfg, corpus, card)
    batch = next(b for b in lstm_iter(mx, corpus, cfg)
                 if b.bucket_key == max(cfg["buckets"]))
    metric = mx.metric.Perplexity(0)
    out["profile"] = profile_one_step(
        lambda: mod.fit_step(batch, metric), card, "lstm profile",
        cfg["batch"], dtype="fp32", classes=LSTM_CLASSES)
    del mod
    out["fixed"] = lstm_fixed_lane(mx, cfg, card)
    print(f"phase 11c/d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["control_flow"] = lstm_control_flow(mx, card)
    print(f"phase 11e: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    launches = [w.launches for w in counted]
    print(f"lstm: K1/K2/K3 launches over phase 11: {launches} (no TPU "
          f"kernel is on the LSTM's paths)")
    check(launches == [0, 0, 0], "a K1/K2/K3 kernel ran on the LSTM paths")
    return out


# -- phase 12: BASELINE config #2 from a .rec -------------------------------

def imagenet_unit(mx, data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9):
    """symbols/resnet.py `residual_unit` on the port's mx.sym: the
    pre-activation unit (reference resnet.py residual_unit)."""
    sym = mx.sym
    if bottle_neck:
        bn1 = sym.BatchNorm(data, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn1")
        act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
        conv1 = sym.Convolution(act1, num_filter=int(num_filter * 0.25),
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn2 = sym.BatchNorm(conv1, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn2")
        act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
        conv2 = sym.Convolution(act2, num_filter=int(num_filter * 0.25),
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn3 = sym.BatchNorm(conv2, fix_gamma=False, eps=2e-5,
                            momentum=bn_mom, name=name + "_bn3")
        act3 = sym.Activation(bn3, act_type="relu", name=name + "_relu3")
        conv3 = sym.Convolution(act3, num_filter=num_filter, kernel=(1, 1),
                                stride=(1, 1), pad=(0, 0), no_bias=True,
                                name=name + "_conv3")
        shortcut = data if dim_match else sym.Convolution(
            act1, num_filter=num_filter, kernel=(1, 1), stride=stride,
            no_bias=True, name=name + "_sc")
        return conv3 + shortcut
    bn1 = sym.BatchNorm(data, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn1")
    act1 = sym.Activation(bn1, act_type="relu", name=name + "_relu1")
    conv1 = sym.Convolution(act1, num_filter=num_filter, kernel=(3, 3),
                            stride=stride, pad=(1, 1), no_bias=True,
                            name=name + "_conv1")
    bn2 = sym.BatchNorm(conv1, fix_gamma=False, momentum=bn_mom, eps=2e-5,
                        name=name + "_bn2")
    act2 = sym.Activation(bn2, act_type="relu", name=name + "_relu2")
    conv2 = sym.Convolution(act2, num_filter=num_filter, kernel=(3, 3),
                            stride=(1, 1), pad=(1, 1), no_bias=True,
                            name=name + "_conv2")
    shortcut = data if dim_match else sym.Convolution(
        act1, num_filter=num_filter, kernel=(1, 1), stride=stride,
        no_bias=True, name=name + "_sc")
    return conv2 + shortcut


def imagenet_symbol(mx, num_classes, num_layers, image_shape, bn_mom=0.9):
    """symbols/resnet.py `get_symbol` (its `resnet`, the ImageNet branch
    and the CIFAR branch) on the port's mx.sym."""
    sym = mx.sym
    nchannel, height, _ = image_shape
    if height <= 28:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            units = [(num_layers - 2) // 9] * num_stages
            filter_list, bottle_neck = [16, 64, 128, 256], True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            units = [(num_layers - 2) // 6] * num_stages
            filter_list, bottle_neck = [16, 16, 32, 64], False
        else:
            raise ValueError(f"no experiments done on num_layers "
                             f"{num_layers}")
    else:
        num_stages = 4
        filter_list, bottle_neck = (
            ([64, 256, 512, 1024, 2048], True) if num_layers >= 50 else
            ([64, 64, 128, 256, 512], False))
        units = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                 101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
                 200: [3, 24, 36, 3]}[num_layers]
    body = sym.BatchNorm(sym.Variable(name="data"), fix_gamma=True,
                         eps=2e-5, momentum=bn_mom, name="bn_data")
    if height <= 32:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(body, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(body, fix_gamma=False, eps=2e-5,
                             momentum=bn_mom, name="bn0")
        body = sym.Activation(body, act_type="relu", name="relu0")
        body = sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           pool_type="max")
    for i in range(num_stages):
        stride = (1, 1) if i == 0 and height > 32 else (2, 2) if i > 0 \
            else (1, 1)
        body = imagenet_unit(mx, body, filter_list[i + 1], stride, False,
                             f"stage{i + 1}_unit1", bottle_neck, bn_mom)
        for j in range(units[i] - 1):
            body = imagenet_unit(mx, body, filter_list[i + 1], (1, 1), True,
                                 f"stage{i + 1}_unit{j + 2}", bottle_neck,
                                 bn_mom)
    bn1 = sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=bn_mom,
                        name="bn1")
    relu1 = sym.Activation(bn1, act_type="relu", name="relu1")
    pool1 = sym.Pooling(relu1, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    fc1 = sym.FullyConnected(sym.Flatten(pool1), num_hidden=num_classes,
                             name="fc1")
    return sym.SoftmaxOutput(fc1, name="softmax")


def imagenet_iter(mx, rec, batch, **kw):
    """train_imagenet.py's training iterator over `rec` (`rec_iters`,
    :42-52), preprocess_threads = the host's cores."""
    args = dict(path_imgrec=rec, data_shape=IMAGE, batch_size=batch,
                resize=IMAGENET_RESIZE, rand_crop=True, rand_mirror=True,
                shuffle=True, preprocess_threads=os.cpu_count(), seed=SEED,
                **IMAGENET_MEAN)
    args.update(kw)
    return mx.io.ImageRecordIter(**args)


def first_batches(it, k):
    """The first `k` batches of `it`, then its workers stopped."""
    out = []
    for b in it:
        out.append(b)
        if len(out) == k:
            break
    it.close()
    return out


def imagenet_corpus(mx, tmp, corpus=None, label="imagenet 12a"):
    """Phase 12a's corpus: IMAGENET_CORPUS images (or `corpus`'s n, h,
    w) packed by the port's recordio (JPEG through a codec that imports,
    else PPM), encoded on every core.  Returns (.rec path, format)."""
    from concurrent.futures import ThreadPoolExecutor
    from incubator_mxnet_tpu_torch import image, recordio
    n, h, w = ((corpus or IMAGENET_CORPUS)[k] for k in ("n", "h", "w"))
    route = image.decode_route()
    fmt = ".jpg" if route in ("cv2", "pil") else ".ppm"
    cv2 = image.cv2_module()

    def encode(i):
        rng = np.random.RandomState(SEED + i)
        img = rng.randint(0, 256, (h, w, 3), np.uint8)
        if cv2 is not None:      # noise compresses badly: blur it
            img = cv2.GaussianBlur(img, (9, 9), 4)
        return recordio.pack_img(
            recordio.IRHeader(0, float(i % CLASSES), i, 0), img,
            img_fmt=fmt)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        packed = list(ex.map(encode, range(n)))
    rec = os.path.join(tmp, "train.rec")
    w_ = recordio.MXIndexedRecordIO(os.path.join(tmp, "train.idx"), rec,
                                    "w")
    for i, s in enumerate(packed):
        w_.write_idx(i, s)
    w_.close()
    size = os.path.getsize(rec)
    print(f"{label}: corpus of {n} images {h}x{w}, labels i % "
          f"{CLASSES}, packed as {fmt[1:].upper()} (decode route {route}) "
          f"in {time.perf_counter() - t0:.1f} s: {size / 1e6:.1f} MB, "
          f"{size / n / 1e3:.1f} kB an image; host cores "
          f"{os.cpu_count()}")
    if fmt == ".ppm":
        print(f"{label}: no codec imports on this machine: the corpus is "
              "PPM and the card's JPEG decode rate is not measured")
    return rec, fmt


def imagenet_data_checks(mx, rec):
    """Phase 12a: IMAGENET_CHECK batches (mean and std both set), each
    held bit for bit: the native library's finish against the numpy
    finish (fp32 NCHW and uint8 NHWC); the ring's card batches against
    the iterator's host batches; the uint8 batches through ImageNormalize
    (normalize_symbol) on the card against the host fp32 finish."""
    from incubator_mxnet_tpu_torch import io_plane, native
    batch, k = IMAGENET_CHECK
    check(native.lib() is not None, "the native IO library did not build "
          f"on this machine: {native.unavailable_reason()}")

    def host(u8, use_native=True):
        lib = native.lib
        if not use_native:
            native.lib = lambda: None
        try:
            return [(b.data[0].asnumpy(), b.label[0].asnumpy()) for b in
                    first_batches(imagenet_iter(mx, rec, batch,
                                                device_augment=u8,
                                                **IMAGENET_STD), k)]
        finally:
            native.lib = lib

    def same(a, b):
        return len(a) == len(b) == k and all(
            x.dtype == y.dtype and np.array_equal(x, y) and
            np.array_equal(lx, ly) for (x, lx), (y, ly) in zip(a, b))

    out = {}
    for u8 in (False, True):
        wire = "uint8" if u8 else "float32"
        nat, plain = host(u8), host(u8, use_native=False)
        check(same(nat, plain), f"12a: the native and numpy finishes "
              f"({wire}) give different batches")
        ring = io_plane.DevicePrefetchIter(
            imagenet_iter(mx, rec, batch, device_augment=u8,
                          **IMAGENET_STD),
            placement=io_plane.RingPlacement(
                ctx=mx.gpu(0),
                dtypes=[torch.uint8 if u8 else torch.float32, None]))
        card_batches = [ring.next() for _ in range(k)]
        ring.close()
        on_card = all(d.data.device.type == mx.gpu(0).torch_device.type
                      for b in card_batches for d in b.data + b.label)
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy())
               for b in card_batches]
        check(on_card and same(got, nat), f"12a: the ring's card batches "
              f"({wire}) differ from the iterator's host batches")
        out[wire] = (nat, card_batches)
    wire_it = imagenet_iter(mx, rec, batch, device_augment=True,
                            **IMAGENET_STD)
    norm = wire_it.normalize_symbol(mx.sym.Variable("data"))
    wire_it.close()
    equal = 0
    for b, (want, _) in zip(out["uint8"][1], out["float32"][0]):
        exe = norm.bind(mx.gpu(0), {"data": b.data[0]})
        got = exe.forward()[0]
        equal += int(np.array_equal(got.asnumpy(), want))
    check(equal == k, "12a: uint8 wire + ImageNormalize on the card "
          "differs from the host fp32 finish")
    print(f"imagenet 12a: native vs numpy finish (fp32 NCHW, uint8 NHWC), "
          f"ring's card batches vs the host batches (both wires), uint8 + "
          f"ImageNormalize on the card vs the host fp32 finish: {k} "
          f"batches of {batch} each, all bit for bit ok; native IO "
          f"library {native.lib_path().name}")


def imagenet_steps(mx, sym, ctx, batches, teacher=None):
    """The fused steps of the config's SGD (IMAGENET_OPT, rescale
    1/batch) in float64 on `ctx`, from Xavier parameters under
    mx.random.seed(SEED), on `batches`: the loss of each step and the
    states before the first and after each; with `teacher`, step k
    starts from the teacher's state before it (as `resnet_steps`)."""
    batch = batches[0].data[0].shape[0]
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind([("data", (batch,) + IMAGE)], [("softmax_label", (batch,))])
    as_float64(mod)
    mx.random.seed(SEED)
    mod.init_params(resnet_init(mx))
    mod.init_optimizer(optimizer_params=dict(IMAGENET_OPT,
                                             rescale_grad=1.0 / batch))
    losses, states = [], [resnet_state(mod)]
    for k, b in enumerate(batches):
        if teacher is not None and k:
            params, moms, auxs = teacher[k]
            mod.set_params(params, auxs)
            for i, n in enumerate(mod._exec_group.param_names):
                mod._updater.states[i]._set_data(moms[n])
        mod.fit_step(b, mx.metric.create(["acc", mx.metric.TopKAccuracy(
            top_k=5)]))
        losses.append(cross_entropy(mod.get_outputs()[0], b.label[0]))
        states.append(resnet_state(mod))
    check(mod._fused_step is not None and mod._fused_step.steps ==
          len(batches), f"imagenet parity on {ctx}: the fused step did "
          "not run every step")
    return losses, states


def imagenet_pool_routes(params, x, ctx):
    """Which element wins each window of the v2 network's max-pool at
    these parameters and images, on `ctx`, by the torch calls the port
    makes: bn_data (fix_gamma, the batch's statistics), conv0 (7x7/2),
    bn0, relu, the 3x3/2 max-pool over -inf padding."""
    import torch.nn.functional as F
    dev = ctx.torch_device

    def t(name):
        return torch.from_numpy(params[name]).to(dev)

    beta = t("bn_data_beta")
    h = torch.native_batch_norm(
        torch.from_numpy(x).to(dev, beta.dtype), torch.ones_like(beta),
        beta, None, None, True, 0.0, 2e-5)[0]
    h = F.conv2d(h, t("conv0_weight"), stride=2, padding=3)
    h = torch.relu(torch.native_batch_norm(h, t("bn0_gamma"), t("bn0_beta"),
                                           None, None, True, 0.0, 2e-5)[0])
    h = F.pad(h, (1, 1, 1, 1), value=-math.inf)
    return F.max_pool2d(h, 3, 2, return_indices=True)[1].cpu()


def imagenet_flipped(mx, cpu_params, gpu_params, x):
    return int((imagenet_pool_routes(cpu_params, x, mx.cpu()) !=
                imagenet_pool_routes(gpu_params, x, mx.gpu(0))).sum())


def imagenet_parity(mx, sym, rec):
    """Phase 12b: IMAGENET_PARITY fused steps of the full-width network
    at 224 on the card against the CPU in float64, on the iterator's
    batches, from the same Xavier parameters: 7a's gates (the loss of
    every free-running step within rtol; each card step from the CPU's
    state: parameters, momenta and aux arrays within PARITY_TOL; bn_data,
    conv0 and bn0 excused only at a step where a max-pool window flipped
    between the devices)."""
    batch, steps = IMAGENET_PARITY
    batches = first_batches(imagenet_iter(mx, rec, batch), steps)
    xs = [b.data[0].asnumpy() for b in batches]
    t0 = time.perf_counter()
    cpu_loss, cpu = imagenet_steps(mx, sym, mx.cpu(), batches)
    t_cpu = time.perf_counter() - t0
    gpu_loss, gpu = imagenet_steps(mx, sym, mx.gpu(0), batches)
    _, forced = imagenet_steps(mx, sym, mx.gpu(0), batches, teacher=cpu)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    free_flips = sum(imagenet_flipped(mx, c[0], g[0], x)
                     for c, g, x in zip(cpu, gpu, xs))
    zero = bn_fed_biases(sym)
    excusable = ("bn_data", "conv0", "bn0")
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, x in enumerate(xs):
        n = imagenet_flipped(mx, cpu[k][0], cpu[k][0], x)
        skip = excusable if n else ()
        after, ref = forced[k + 1], cpu[k + 1]
        held = max([held] + [resnet_ratio(a, r, zero, skip)
                             for a, r in zip(after, ref)])
        if n:
            flips.append(f"step {k + 1}: {n}")
            excused = max([excused] + [resnet_ratio(a, r, zero)
                                       for a, r in zip(after, ref)])
    ok = loss_err <= PARITY_TOL[0] and held[0] <= 1 and \
        all(np.isfinite(gpu_loss))
    print(f"imagenet 12b: {steps} fused steps of the ResNet-{IMAGENET_LAYERS}"
          f" v2 at batch {batch}, {IMAGE[1]}x{IMAGE[2]}, float64, on the "
          f"iterator's batches, card vs CPU (CPU {t_cpu:.1f} s): loss "
          f"{' '.join(f'{v:.6f}' for v in gpu_loss)}; max relative loss err "
          f"{loss_err:.2e} (rtol {PARITY_TOL[0]:g}); each step from the "
          f"CPU's state: parameters, momenta and {len(cpu[0][2])} aux "
          f"arrays at {held[0]:.3f} of the tolerance (worst {held[1]}) "
          f"(rtol {PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}*max|array|) "
          f"{'ok' if ok else 'FAIL'}")
    note = f"; at those steps bn_data, conv0 and bn0 at {excused[0]:.3f} " \
        f"of the tolerance (worst {excused[1]}), not held" if flips else ""
    print(f"imagenet 12b: max-pool windows flipped between the CPU and the "
          f"card from the CPU's state: {', '.join(flips) or 'none'}{note}; "
          f"along the free-running steps: {free_flips}")
    check(ok, "imagenet: the card's float64 steps disagree with the CPU's")
    return {"worst": held[0], "loss_err": loss_err, "cpu_s": t_cpu}


def imagenet_lane(mx, sym, rec, card, wire):
    """Phase 12c: the config through the public Module.fit for 2 epochs
    of the corpus's batches (epoch 0 warms up; epoch 1 is timed), fed by
    the .rec through the ring (`wire` "float32" or "uint8"), or by one
    resident batch on the card (`wire` "resident").  images/s over epoch
    1 (its first batch waits on the epoch-end work and the ring's
    restart) and over its batches from the second on (steady), the
    median step ms (CUDA events at batch ends), ring stalls over epoch
    1, the h2d bytes a batch and the ring's put rate, peak memory.
    Returns (module, numbers)."""
    batch = IMAGENET_BATCH
    per_epoch = IMAGENET_CORPUS["n"] // batch
    if wire == "resident":
        it = resident_iter(mx, batch, "float32", per_epoch)
        net = sym
    else:
        it = imagenet_iter(mx, rec, batch, device_augment=wire == "uint8")
        net = sym
        if wire == "uint8":
            net = sym.__copy__()
            net._compose(data=it.normalize_symbol(mx.sym.Variable("data")))
    mod = mx.mod.Module(net, context=mx.gpu(0))
    events, edges, rings = [], {}, {}

    def probe(p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        key = (p.epoch, p.nbatch)
        if key in ((0, per_epoch - 1), (1, 0), (1, per_epoch - 1)):
            torch.cuda.synchronize()
            edges[key] = time.perf_counter()
            ring = p.locals.get("train_data")
            if hasattr(ring, "ring_stats"):
                rings[key] = ring.ring_stats()
            if p.epoch == 1 and p.nbatch == per_epoch - 1:
                edges["metrics"] = p.eval_metric.get()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=2, optimizer="sgd",
            optimizer_params=dict(IMAGENET_OPT, rescale_grad=1.0 / batch),
            initializer=resnet_init(mx), kvstore="device",
            eval_metric=["acc", mx.metric.TopKAccuracy(top_k=5)],
            batch_end_callback=[mx.callback.Speedometer(batch, 20), probe])
    wall = time.perf_counter() - t0
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = 2 * per_epoch
    check(mod._fused_step is not None and mod._fused_step.steps == steps,
          f"imagenet {wire}: the fused step ran "
          f"{getattr(mod._fused_step, 'steps', 0)} of {steps} steps")
    start, first, end = (0, per_epoch - 1), (1, 0), (1, per_epoch - 1)
    images_s = batch * per_epoch / (edges[end] - edges[start])
    steady = batch * (per_epoch - 1) / (edges[end] - edges[first])
    step_ms = [a.elapsed_time(b) for a, b in
               zip(events[per_epoch + 1:], events[per_epoch + 2:])]
    names, values = edges["metrics"]
    out = {"images_s": images_s, "steady_images_s": steady,
           "step_ms": statistics.median(step_ms), "peak_gib": mem,
           "metrics": dict(zip(names, values))}
    line = (f"imagenet 12c {wire}: {steps} steps through Module.fit in "
            f"{wall:.1f} s (epoch 0 warm), fused step every step; epoch 1 "
            f"{images_s:.1f} images/s, batches 1-{per_epoch - 1} "
            f"{steady:.1f} images/s, step median {out['step_ms']:.3f} ms "
            f"(CUDA events); peak memory {mem:.2f} GiB; epoch-1 train "
            + ", ".join(f"{n} {v:.4f}" for n, v in zip(names, values)))
    if wire != "resident":
        r0, r1 = rings[start], rings[end]
        batches = r1["batches"] - r0["batches"]
        nbytes = r1["bytes"] - r0["bytes"]
        out.update(stalls=r1["stalls"] - r0["stalls"],
                   stall_s=r1["stall_s"] - r0["stall_s"],
                   bytes_batch=nbytes / max(batches, 1),
                   put_GBps=nbytes / max(r1["h2d_s"] - r0["h2d_s"], 1e-9)
                   / 1e9)
        line += (f"; ring over epoch 1: {out['stalls']} stalls "
                 f"({out['stall_s'] * 1e3:.1f} ms), "
                 f"{out['bytes_batch'] / 1e6:.2f} MB h2d a batch, "
                 f"{out['put_GBps']:.2f} GB/s staged+copied a put")
    print(line + f" [{card}]")
    check(all(np.isfinite(v) for v in values),
          f"imagenet {wire}: a training metric is not finite")
    return mod, out


def imagenet_iter_rate(mx, rec, card, u8):
    """Phase 12c: the iterator alone over 2 epochs on every core."""
    it = imagenet_iter(mx, rec, IMAGENET_BATCH, device_augment=u8)
    t0 = time.perf_counter()
    n = 0
    for epoch in range(2):
        if epoch:
            it.reset()
        for b in it:
            n += b.data[0].shape[0] - (b.pad or 0)
    dt = time.perf_counter() - t0
    it.close()
    rate = n / dt
    print(f"imagenet 12c: ImageRecordIter alone ({'uint8 NHWC' if u8 else 'fp32 NCHW'}"
          f" finish), {os.cpu_count()} threads: {n} images in {dt:.2f} s, "
          f"{rate:.1f} images/s [{card}]")
    return rate


def imagenet_profile(mx, mod, rec, card, tries=3):
    """Phase 12d: two warm fp32 steps of the lane's module back to back
    on ring batches, under torch.profiler, as `fit` runs them: the second
    `next()` pops while the card still runs the first step, and the
    feeder copies the next batch then.  The host ms to enqueue the two
    steps, the device's busy share, the ring's h2d copies in the window,
    the time they overlap the steps' kernels (a copy on the compute
    stream could overlap none) and the streams (CUPTI's ids) of the
    copies and the kernels."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch import io_plane
    ring = io_plane.DevicePrefetchIter(
        imagenet_iter(mx, rec, IMAGENET_BATCH),
        placement=mod._fused_step.ring_placement)
    metric = mx.metric.create(["acc", mx.metric.TopKAccuracy(top_k=5)])

    def step():
        check(mod._fused_step(ring.next(), metric), "12d: the fused step "
              "declined a ring batch")

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    time.sleep(0.5)            # the queue refills before the window
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            step()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        spans = sorted((e.time_range.start, e.time_range.end, e.name,
                        getattr(e, "device_resource_id", None))
                       for e in events)
        copies = [s for s in spans if "HtoD" in s[2]]
        if spans and copies:
            break
    ring.close()
    check(spans, "12d: the profiler saw no device activity in the steps")
    kernels = [s for s in spans if "Memcpy" not in s[2] and
               "Memset" not in s[2]]
    busy, edge = 0.0, -math.inf
    for start, end, _, _ in spans:
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    merged = []
    for start, end, _, _ in kernels:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    copy_us = sum(e - s for s, e, _, _ in copies)
    overlap_us = sum(max(0.0, min(e, me) - max(s, ms))
                     for s, e, _, _ in copies for ms, me in merged)
    out = {"busy": busy / 1e3 / wall_ms, "host_ms": host_ms,
           "wall_ms": wall_ms, "copies": len(copies),
           "copy_ms": copy_us / 1e3, "overlap_ms": overlap_us / 1e3}
    first = spans[0][0]
    for s0, e0, name, stream in copies:
        print(f"imagenet 12d: {name[:40]} at {(s0 - first) / 1e3:.2f} ms "
              f"into the window's device work, {(e0 - s0) / 1e3:.3f} ms, "
              f"stream {stream}")
    streams = sorted({k[3] for k in kernels}, key=str)
    print(f"imagenet 12d: two warm fp32 steps at batch {IMAGENET_BATCH} on "
          f"ring batches: {host_ms:.2f} ms of host time to enqueue, "
          f"{wall_ms:.2f} ms to finish, {len(kernels)} kernels on streams "
          f"{streams}, device busy {out['busy']:.3f}; {len(copies)} h2d "
          f"copies, {out['copy_ms']:.3f} ms, {out['overlap_ms']:.3f} ms of "
          f"it under the steps' kernels [{card}]")
    return out


def imagenet_phase(card, workdir):
    """Phase 12; returns the numbers of the summary line.  The counts of
    K1, K2 and K3 are set to 0 before it and must stay 0: no TPU kernel
    is on this path (the network's one FC has no ReLU)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    counted = (fc_relu, flash_fwd, flash_fwd_stream)
    for wrapper in counted:
        wrapper.launches = 0
    sym = imagenet_symbol(mx, CLASSES, IMAGENET_LAYERS, IMAGE)
    args, _, aux = sym.infer_shape(data=(IMAGENET_BATCH,) + IMAGE)
    learned = [a for n, a in zip(sym.list_arguments(), args)
               if n not in ("data", "softmax_label")]
    print(f"imagenet: symbols/resnet.py ResNet-{IMAGENET_LAYERS} v2 on "
          f"mx.sym: {len(learned)} learned arguments of "
          f"{sum(math.prod(a) for a in learned)} values, {len(aux)} aux")
    out = {}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        t0 = time.perf_counter()
        rec, out["format"] = imagenet_corpus(mx, tmp)
        imagenet_data_checks(mx, rec)
        print(f"phase 12a: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["parity"] = imagenet_parity(mx, sym, rec)
        print(f"phase 12b: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["iter_f32"] = imagenet_iter_rate(mx, rec, card, False)
        out["iter_u8"] = imagenet_iter_rate(mx, rec, card, True)
        mod, out["float32"] = imagenet_lane(mx, sym, rec, card, "float32")
        out["profile"] = imagenet_profile(mx, mod, rec, card)
        del mod
        gc.collect()
        torch.cuda.empty_cache()
        _, out["uint8"] = imagenet_lane(mx, sym, rec, card, "uint8")
        _, out["resident"] = imagenet_lane(mx, sym, rec, card, "resident")
        gc.collect()
        torch.cuda.empty_cache()
        res = out["resident"]
        for wire in ("float32", "uint8"):
            lane = out[wire]
            lane["real_vs_resident"] = lane["images_s"] / res["images_s"]
            lane["steady_vs_resident"] = \
                lane["steady_images_s"] / res["steady_images_s"]
            print(f"imagenet 12c {wire}: real_vs_resident "
                  f"{lane['real_vs_resident']:.3f} (epoch 1), "
                  f"{lane['steady_vs_resident']:.3f} (steady) [{card}]")
        print(f"phase 12c/d: {time.perf_counter() - t0:.1f} s")
    launches = [w.launches for w in counted]
    print(f"imagenet: K1/K2/K3 launches over phase 12: {launches} (no TPU "
          f"kernel is on this path)")
    check(launches == [0, 0, 0], "a K1/K2/K3 kernel ran on config #2's path")
    return out


# phase 13: BASELINE config #5, examples/ssd/train_ssd.py's SSD-VGG16 at
# the example's defaults (:142-151): the full-width VGG16-reduced SSD, 3
# classes, 128x128, batch 16, 256 synthetic images, 3 epochs, SGD lr 0.01
# momentum 0.9 wd 5e-4 rescale 1/16, Xavier, MultiBoxMetric,
# Speedometer(16, 10)
SSD_CFG = dict(classes=3, image=128, batch=16, n=256, epochs=3)
SSD_OPT = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4}
SSD_SIZES = [(0.1, 0.14), (0.27, 0.38), (0.54, 0.66), (0.78, 0.9)]
SSD_RATIOS = [(1.0, 2.0, 0.5)] * 4
SSD_PARITY = (4, 2)           # 13b: (batch, steps) card vs CPU, fp32
SSD_OPS_BATCH300 = 4          # 13a: the batch at 300x300 (the CPU's IoUs)
SSD300 = dict(image=300, batch=16, warm=2, timed=8)   # 13c: SSD300's input
SSD_REC = 256                 # 13e: images packed as JPEG at 128x128
SSD_CHAINS = (1108, 5936)     # 13a: suppression chains (N at 128, 300)
SSD_NEAR = 1e-6               # 13a/b: a near tie
SSD_OP_TOL = (1e-5, 1e-6)     # 13a: rtol, atol * max|ref|
SSD_DEV = "cuda"              # the card's torch device (a CPU rehearsal
                              # of phase 13 points it at "cpu")
# phase 13d's kernel classes: the NMS rounds' batched products are cuBLAS
# gemv kernels; cuDNN picks FFT algorithms for some of the 3x3 convolutions
SSD_OP_CLASSES = (("sort (MultiBoxDetection)", ("sort", "Sort")),
                  ("NMS rounds (batched gemv)", ("gemv",)),
                  ("convolution (cuDNN FFT)", ("fft", "complex"))) + \
    KERNEL_CLASSES


def ssd_conv_block(mx, data, name, num_filter, n_convs):
    """train_ssd.py `_conv_block` (:33), on the port's mx.sym."""
    sym = mx.sym
    for i in range(n_convs):
        data = sym.Convolution(data, kernel=(3, 3), pad=(1, 1),
                               num_filter=num_filter,
                               name=f"{name}_conv{i}")
        data = sym.Activation(data, act_type="relu")
    return sym.Pooling(data, kernel=(2, 2), stride=(2, 2), pool_type="max",
                       name=f"{name}_pool"), data


def ssd_vgg16_reduced(mx, data, small=False):
    """train_ssd.py `vgg16_reduced` (:43): the feature maps SSD taps
    (conv4_3, fc7 as a dilated conv, two extra layers)."""
    sym = mx.sym
    f = 0.25 if small else 1.0
    p1, _ = ssd_conv_block(mx, data, "b1", int(64 * f), 2)
    p2, _ = ssd_conv_block(mx, p1, "b2", int(128 * f), 2)
    p3, _ = ssd_conv_block(mx, p2, "b3", int(256 * f), 3)
    p4, c4 = ssd_conv_block(mx, p3, "b4", int(512 * f), 3)
    p5, _ = ssd_conv_block(mx, p4, "b5", int(512 * f), 3)
    fc6 = sym.Convolution(p5, kernel=(3, 3), pad=(3, 3), dilate=(3, 3),
                          num_filter=int(1024 * f), name="fc6")
    fc6 = sym.Activation(fc6, act_type="relu")
    fc7 = sym.Convolution(fc6, kernel=(1, 1), num_filter=int(1024 * f),
                          name="fc7")
    fc7 = sym.Activation(fc7, act_type="relu")
    e1 = sym.Convolution(fc7, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         num_filter=int(256 * f), name="extra1")
    e1 = sym.Activation(e1, act_type="relu")
    e2 = sym.Convolution(e1, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                         num_filter=int(128 * f), name="extra2")
    e2 = sym.Activation(e2, act_type="relu")
    return [c4, fc7, e1, e2]


def ssd_symbol(mx, num_classes, small=False):
    """train_ssd.py `ssd_symbol` (:68): per-scale anchors and class/box
    predictors, MultiBoxTarget, SoftmaxOutput and MakeLoss(smooth_l1)
    heads, MultiBoxDetection; outputs [cls_prob, loc_loss,
    BlockGrad(cls_target), BlockGrad(det)]."""
    sym = mx.sym
    data = sym.Variable("data")
    label = sym.Variable("label")
    feats = ssd_vgg16_reduced(mx, data, small=small)
    cls_preds, loc_preds, anchors = [], [], []
    for i, (feat, sz, rt) in enumerate(zip(feats, SSD_SIZES, SSD_RATIOS)):
        na = len(sz) + len(rt) - 1
        cls = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=na * (num_classes + 1),
                              name=f"cls_pred{i}")
        loc = sym.Convolution(feat, kernel=(3, 3), pad=(1, 1),
                              num_filter=na * 4, name=f"loc_pred{i}")
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_preds.append(sym.Reshape(cls, shape=(0, -1, num_classes + 1)))
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_preds.append(sym.Reshape(loc, shape=(0, -1)))
        anchors.append(sym.MultiBoxPrior(feat, sizes=sz, ratios=rt,
                                         clip=True))
    cls_concat = sym.concat(*cls_preds, dim=1)
    cls_concat = sym.transpose(cls_concat, axes=(0, 2, 1))
    loc_concat = sym.concat(*loc_preds, dim=1)
    anchor_concat = sym.concat(*anchors, dim=1)
    tmp = sym.MultiBoxTarget(anchor_concat, label, cls_concat,
                             overlap_threshold=0.5,
                             negative_mining_ratio=3,
                             variances=(0.1, 0.1, 0.2, 0.2),
                             name="multibox_target")
    loc_target, loc_mask, cls_target = tmp[0], tmp[1], tmp[2]
    cls_prob = sym.SoftmaxOutput(cls_concat, cls_target,
                                 ignore_label=-1, use_ignore=True,
                                 multi_output=True,
                                 normalization="valid", name="cls_prob")
    loc_diff = loc_mask * (loc_concat - loc_target)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            grad_scale=1.0, normalization="valid",
                            name="loc_loss")
    det = sym.MultiBoxDetection(cls_prob, loc_concat, anchor_concat,
                                nms_threshold=0.45, force_suppress=False,
                                variances=(0.1, 0.1, 0.2, 0.2),
                                name="detection")
    det = sym.BlockGrad(det)
    return sym.Group([cls_prob, loc_loss, sym.BlockGrad(cls_target), det])


def ssd_synthetic(n, image=128, num_classes=3, max_obj=3):
    """train_ssd.py `SyntheticDetIter`'s arrays (:120): images with 1-3
    coloured rectangles, labels (n, max_obj, 5), -1 padded."""
    rng = np.random.RandomState(0)
    x = rng.normal(0, 0.1, (n, 3, image, image)).astype("f4")
    y = np.full((n, max_obj, 5), -1.0, "f4")
    for i in range(n):
        for j in range(rng.randint(1, max_obj + 1)):
            cls = rng.randint(0, num_classes)
            w, h = rng.uniform(0.2, 0.5, 2)
            x1 = rng.uniform(0, 1 - w)
            y1 = rng.uniform(0, 1 - h)
            y[i, j] = [cls, x1, y1, x1 + w, y1 + h]
            xa, ya = int(x1 * image), int(y1 * image)
            xb, yb = int((x1 + w) * image), int((y1 + h) * image)
            x[i, cls % 3, ya:yb, xa:xb] += 1.0
    return x, y


def ssd_iter(mx, n, batch, image=128, num_classes=3):
    """`SyntheticDetIter(n, batch, image, num_classes)`: the arrays in a
    shuffled NDArrayIter (np.random seeded first, as the JAX one
    shuffles with it)."""
    x, y = ssd_synthetic(n, image, num_classes)
    np.random.seed(SEED)
    return mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=True,
                             label_name="label")


def ssd_metric(mx, on_device=False):
    """train_ssd.py's `MultiBoxMetric` (:160): mean cross-entropy of the
    class targets that are not -1, mean smooth-L1; with `on_device`, a
    copy that also counts on the card (`device_update`), so the fused
    step takes its batches."""

    class MultiBoxMetric(mx.metric.EvalMetric):
        def __init__(self):
            super().__init__("MultiBox")
            self.num = 2
            self.reset()

        def reset(self):
            self.sum_ce, self.n_ce = 0.0, 0
            self.sum_l1, self.n_l1 = 0.0, 0

        def update(self, labels, preds):
            cls_prob = preds[0].asnumpy()
            loc_loss = preds[1].asnumpy()
            cls_target = preds[2].asnumpy()
            valid = cls_target >= 0
            idx = np.maximum(cls_target.astype(int), 0)
            b, n = np.indices(idx.shape)
            p = cls_prob[b, idx, n]
            ce = -np.log(np.maximum(p, 1e-12))[valid].sum()
            self.sum_ce += ce
            self.n_ce += int(valid.sum())
            self.sum_l1 += float(loc_loss.sum())
            self.n_l1 += loc_loss.size

        def get(self):
            return (["CrossEntropy", "SmoothL1"],
                    [self.sum_ce / max(1, self.n_ce),
                     self.sum_l1 / max(1, self.n_l1)])

    class DeviceMultiBoxMetric(MultiBoxMetric):
        def device_update(self, labels, preds):
            cls_prob, loc_loss, cls_target = (p.data for p in preds[:3])
            valid = cls_target >= 0
            p = torch.gather(cls_prob, 1,
                             cls_target.clamp(min=0).long()[:, None])[:, 0]
            ce = torch.where(valid, -torch.log(torch.clamp(p, min=1e-12)),
                             0.0)
            return (ce.sum(), valid.sum(), loc_loss.sum(),
                    torch.tensor(loc_loss.numel(), device=p.device))

        def _accumulate(self, *totals):
            totals = tuple(t.double() for t in totals)
            prev = getattr(self, "_dev", None)
            self._dev = totals if prev is None else \
                tuple(a + b for a, b in zip(prev, totals))

        def get(self):
            if getattr(self, "_dev", None) is not None:
                ce, n_ce, l1, n_l1 = torch.stack(self._dev).tolist()
                self.sum_ce += ce
                self.n_ce += int(n_ce)
                self.sum_l1 += l1
                self.n_l1 += int(n_l1)
                self._dev = None
            return super().get()

        def reset(self):
            super().reset()
            self._dev = None

    return DeviceMultiBoxMetric() if on_device else MultiBoxMetric()


def ssd_feature_shapes(mx, image, batch=1):
    """The (B, C, H, W) shapes of the four maps SSD taps at `image`."""
    feats = ssd_vgg16_reduced(mx, mx.sym.Variable("data"))
    _, outs, _ = mx.sym.Group(feats).infer_shape(
        data=(batch, 3, image, image))
    return outs


def op_fn(name, params, *tensors):
    """One registered op of the port called on tensors (the wrapper the
    graph interpreter calls)."""
    from incubator_mxnet_tpu_torch.ops import registry
    op = registry.get(name)
    return op.fn(op.canonicalize_params(params), *tensors)


def ssd_anchors(mx, image, dev):
    """The SSD's anchors at `image`: MultiBoxPrior on each tapped map's
    shape (clip, the example's sizes and ratios), concatenated: (1, N,
    4)."""
    maps = ssd_feature_shapes(mx, image)
    return torch.cat([op_fn("MultiBoxPrior", {"sizes": sz, "ratios": rt,
                                              "clip": True},
                            torch.empty(shape, device=dev))
                      for shape, sz, rt in zip(maps, SSD_SIZES, SSD_RATIOS)],
                     dim=1)


def nms_loop(sup, valid):
    """The JAX ops' greedy suppression box by box (their `fori_loop`
    body), the plain version the NMS route is held to."""
    n = valid.shape[-1]
    alive = valid.clone()
    later = torch.arange(n, device=valid.device)
    for i in range(n):
        row = sup[:, i] & alive[:, i:i + 1] & (later > i)
        alive = alive & ~row
    return alive


def ssd_head_inputs(mx, image, batch, seed=SEED):
    """Seeded head outputs at the SSD's shapes on the CPU: cls_prob (a
    softmax of logits at scale 2), loc_pred (normal, 0.5), the anchors
    and the synthetic labels of the first `batch` images."""
    anchors = ssd_anchors(mx, image, "cpu")
    n = anchors.shape[1]
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.normal(
        0, 2, (batch, SSD_CFG["classes"] + 1, n)).astype("f4"))
    loc = torch.from_numpy(rng.normal(0, 0.5, (batch, 4 * n)).astype("f4"))
    _, labels = ssd_synthetic(batch, image)
    return torch.softmax(logits, 1), loc, anchors, torch.from_numpy(labels)


def target_near_ties(anchors, labels, thresh):
    """(B, N) anchors whose MultiBoxTarget outcome rounding may tip: best
    IoU within SSD_NEAR of the threshold or above the runner-up label by
    less than SSD_NEAR, or a label's best anchor ahead of the next by
    less than SSD_NEAR (both anchors), by the CPU's IoU."""
    from incubator_mxnet_tpu_torch.ops.detection import box_iou_xyxy
    valid = labels[:, :, 0] >= 0
    ious = torch.where(valid[:, None, :],
                       box_iou_xyxy(anchors[0][None], labels[:, :, 1:5]),
                       -1.0)
    near = (ious.amax(2) - thresh).abs() < SSD_NEAR
    top2 = ious.topk(2, dim=2).values
    gap = top2[..., 0] - top2[..., 1]
    near |= (gap > 0) & (gap < SSD_NEAR)
    col = ious.topk(2, dim=1)
    gap = col.values[:, 0] - col.values[:, 1]                   # (B, M)
    close = (gap > 0) & (gap < SSD_NEAR) & valid
    for k in (0, 1):
        hit = torch.zeros_like(near)
        hit.scatter_(1, col.indices[:, k], close)
        near |= hit
    return near


def nms_near_rows(boxes, cls, score, thresh, force=False):
    """Rows of a batch with a pair of candidates whose IoU lies within
    SSD_NEAR of the NMS threshold (same class unless `force`): their
    suppression may tip between devices."""
    from incubator_mxnet_tpu_torch.ops.detection import box_iou_xyxy
    ious = box_iou_xyxy(boxes, boxes)
    near = ((ious - thresh).abs() < SSD_NEAR) & \
        (score[:, :, None] > 0) & (score[:, None, :] > 0)
    if not force:
        near &= cls[:, :, None] == cls[:, None, :]
    return near.flatten(1).any(1)


def op_pair(name, params, inputs, grad_idx=(), seed=SEED):
    """`name` on the CPU and on the card on the same inputs; with
    `grad_idx`, the gradients of those inputs under one seeded
    cotangent of the first output.  Returns ((outs, grads) CPU, (outs,
    grads) card), numpy."""
    res = []
    for dev in ("cpu", SSD_DEV):
        xs = [t.to(dev).clone() for t in inputs]
        for i in grad_idx:
            xs[i].requires_grad_()
        with torch.set_grad_enabled(bool(grad_idx)):
            out = op_fn(name, params, *xs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        grads = []
        if grad_idx:
            ct = torch.from_numpy(np.random.RandomState(seed + 7).normal(
                0, 1, tuple(outs[0].shape)).astype("f4")).to(dev)
            grads = torch.autograd.grad(outs[0], [xs[i] for i in grad_idx],
                                        ct, allow_unused=True)
            grads = [torch.zeros_like(xs[i]) if g is None else g
                     for i, g in zip(grad_idx, grads)]
        res.append(([o.detach().cpu().numpy() for o in outs],
                    [g.detach().cpu().numpy() for g in grads]))
    return res


def op_ratio(got, ref, tol=SSD_OP_TOL):
    """max |got - ref| / (rtol |ref| + atol max|ref|) (at most 1 passes)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = tol[1] * max(np.abs(ref).max(), 1e-30)
    return float((np.abs(got - ref) / (tol[0] * np.abs(ref) + scale)).max())


def ssd_ops(mx, card):
    """Phase 13a: every ported detection, spatial and deformable op on
    the card against the CPU at the SSD's shapes; the NMS route against
    the per-box loop on the card, bitwise."""
    from incubator_mxnet_tpu_torch.ops.detection import (
        detection_candidates, greedy_nms)
    worst = {}
    # MultiBoxPrior: within 1 ulp
    for image in (SSD_CFG["image"], SSD300["image"]):
        a_cpu = ssd_anchors(mx, image, "cpu").numpy()
        a_gpu = ssd_anchors(mx, image, SSD_DEV).cpu().numpy()
        ulps = np.abs(a_gpu - a_cpu) / np.spacing(np.abs(a_cpu).max())
        print(f"ssd 13a: MultiBoxPrior at {image}x{image}: "
              f"{a_cpu.shape[1]} anchors, max |card - CPU| "
              f"{ulps.max():.2f} ulp of the largest coordinate")
        check(ulps.max() <= 1, f"MultiBoxPrior at {image}: card and CPU "
              "differ by more than 1 ulp")
    mt_params = {"overlap_threshold": 0.5, "negative_mining_ratio": 3,
                 "variances": (0.1, 0.1, 0.2, 0.2)}
    det_params = {"nms_threshold": 0.45, "force_suppress": False,
                  "variances": (0.1, 0.1, 0.2, 0.2)}
    full = {"clip": True, "threshold": 0.01, "background_id": 0,
            "nms_topk": -1, **det_params}
    for image, batch in ((SSD_CFG["image"], SSD_CFG["batch"]),
                         (SSD300["image"], SSD_OPS_BATCH300)):
        prob, loc, anchors, labels = ssd_head_inputs(mx, image, batch)
        n = anchors.shape[1]
        (c, _), (g, _) = op_pair("MultiBoxTarget", mt_params,
                                 [anchors, labels, prob])
        near = target_near_ties(anchors, labels, 0.5).numpy()
        diff = (c[2] != g[2]) | (c[1] != g[1]).reshape(
            c[2].shape + (4,)).any(-1)
        unexcused = int((diff & ~near).sum())
        pos = c[1].reshape(c[2].shape + (4,))[..., 0] > 0
        loc_r = op_ratio(np.where(pos[..., None], g[0].reshape(
            pos.shape + (4,)), 0), np.where(pos[..., None], c[0].reshape(
                pos.shape + (4,)), 0))
        worst[f"target{image}"] = loc_r
        print(f"ssd 13a: MultiBoxTarget at N={n}, batch "
              f"{batch}: {int(pos.sum())} positive anchors; "
              f"class targets and masks differ at {int(diff.sum())} "
              f"anchors, {int(near.sum())} near ties, {unexcused} "
              f"unexcused; loc targets at {loc_r:.3f} of the tolerance")
        check(unexcused == 0 and loc_r <= 1, f"MultiBoxTarget at N={n}: "
              "card and CPU disagree")
        (c, _), (g, _) = op_pair("MultiBoxDetection", det_params,
                                 [prob, loc, anchors])
        boxes, score, cls, sup = detection_candidates(
            full, prob, loc, anchors)
        near = nms_near_rows(boxes, cls, score, 0.45).numpy()
        rows = ~(c[0][..., :2] == g[0][..., :2]).all((1, 2))
        unexcused = int((rows & ~near).sum())
        box_r = op_ratio(g[0][..., 2:], c[0][..., 2:])
        worst[f"det{image}"] = box_r
        print(f"ssd 13a: MultiBoxDetection at N={n}, batch "
              f"{batch}: {int((c[0][..., 0] >= 0).sum())} kept "
              f"on the CPU, {int((g[0][..., 0] >= 0).sum())} on the card; "
              f"{int(rows.sum())} rows differ, {int(near.sum())} rows with "
              f"a near tie, {unexcused} unexcused; boxes at {box_r:.3f} of "
              f"the tolerance")
        check(unexcused == 0 and box_r <= 1, f"MultiBoxDetection at N={n}: "
              "card and CPU disagree")
        # box_nms on the detection rows (a second NMS, one id per class)
        rows_in = torch.from_numpy(c[0])
        (cn, _), (gn, _) = op_pair("_contrib_box_nms",
                                   {"overlap_thresh": 0.3, "id_index": 0,
                                    "valid_thresh": 0.05}, [rows_in])
        near = nms_near_rows(rows_in[..., 2:], rows_in[..., 0],
                             rows_in[..., 1], 0.3).numpy()
        rows = ~(cn[0] == gn[0]).all((1, 2))
        print(f"ssd 13a: box_nms (threshold 0.3, by class) on the CPU's "
              f"detections: {int((cn[0][..., 1] >= 0).sum())} kept; "
              f"{int(rows.sum())} rows differ, {int(near.sum())} with a "
              f"near tie, {int((rows & ~near).sum())} unexcused")
        check(not (rows & ~near).any(), "box_nms: card and CPU disagree")
        # the route against the loop on the card, bitwise
        boxes, score, cls, sup = detection_candidates(
            full, prob.to(SSD_DEV), loc.to(SSD_DEV), anchors.to(SSD_DEV))
        valid = score > 0
        t0 = time.perf_counter()
        route = greedy_nms(sup, valid)
        torch.cuda.synchronize()
        t_route = time.perf_counter() - t0
        rounds = greedy_nms.rounds
        t0 = time.perf_counter()
        loop = nms_loop(sup, valid)
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        check(torch.equal(route, loop), f"the NMS route differs from the "
              f"per-box loop on the card at N={n}")
        print(f"ssd 13a: NMS route = per-box loop on the card, bitwise, at "
              f"N={n} x batch {batch}: {rounds} rounds, "
              f"{t_route * 1e3:.2f} ms; the loop {t_loop * 1e3:.1f} ms "
              f"[{card}]")
    # adversarial chains on the card: each box suppresses only the next
    for n in SSD_CHAINS:
        sup = torch.zeros(2, n, n, dtype=torch.bool, device=SSD_DEV)
        i = torch.arange(n - 1, device=SSD_DEV)
        sup[:, i, i + 1] = True
        valid = torch.ones(2, n, dtype=torch.bool, device=SSD_DEV)
        valid[1, ::7] = False
        route = greedy_nms(sup, valid)
        check(torch.equal(route, nms_loop(sup, valid)),
              f"the NMS route differs from the loop on a chain of {n}")
        print(f"ssd 13a: chain of {n} (the worst case): route = loop, "
              f"bitwise, in {greedy_nms.rounds} rounds")
    # ROI, spatial and deformable ops with their gradients at the SSD's
    # conv4_3 map (batch 4, 512 x 16 x 16 at 128x128)
    rng = np.random.RandomState(SEED)

    def rand(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(0, 1, shape)).astype(
            "f4"))

    rois = np.zeros((8, 5), "f4")
    rois[:, 0] = rng.randint(0, 4, 8)
    xy = rng.uniform(0, 80, (8, 2))
    rois[:, 1:3], rois[:, 3:5] = xy, xy + rng.uniform(8, 48, (8, 2))
    rois = torch.from_numpy(rois)
    feat = rand(4, 512, 16, 16)
    grid = torch.from_numpy(rng.uniform(-1.1, 1.1, (4, 2, 16, 16))
                            .astype("f4"))
    theta = torch.tensor([[0.9, 0.1, 0.05, -0.1, 0.8, -0.05]] * 4) + \
        rand(4, 6, scale=0.05)
    cases = [
        ("ROIPooling", {"pooled_size": (7, 7), "spatial_scale": 0.125},
         [feat, rois], [0]),
        ("_contrib_ROIAlign", {"pooled_size": (7, 7),
                               "spatial_scale": 0.125}, [feat, rois], [0]),
        ("BilinearSampler", {}, [feat, grid], [0, 1]),
        ("GridGenerator", {"transform_type": "affine",
                           "target_shape": (16, 16)}, [theta], [0]),
        ("GridGenerator", {"transform_type": "warp"},
         [rand(4, 2, 16, 16)], [0]),
        ("SpatialTransformer", {"target_shape": (16, 16)}, [feat, theta],
         [0, 1]),
        ("Correlation", {"max_displacement": 4, "pad_size": 4,
                         "stride2": 2}, [feat[:, :256], rand(4, 256, 16, 16)],
         [0, 1]),
        ("Crop", {"num_args": 1, "h_w": (8, 8), "center_crop": True},
         [feat], [0]),
        ("_contrib_DeformableConvolution",
         {"kernel": (3, 3), "num_filter": 256, "pad": (1, 1),
          "num_deformable_group": 2},
         [feat, rand(4, 36, 16, 16, scale=0.7),
          rand(256, 512, 3, 3, scale=0.02), rand(256)], [0, 1, 2, 3]),
        ("_contrib_DeformablePSROIPooling",
         {"spatial_scale": 0.125, "output_dim": 4, "group_size": 7,
          "pooled_size": 7, "sample_per_part": 4, "trans_std": 0.1},
         [rand(4, 196, 16, 16), rois, rand(8, 8, 7, 7)], [0, 2]),
    ]
    for name, params, inputs, grad_idx in cases:
        (c, cg), (g, gg) = op_pair(name, params, inputs, grad_idx)
        r = max([op_ratio(a, b) for a, b in zip(g, c)] +
                [op_ratio(a, b) for a, b in zip(gg, cg)])
        worst[name] = max(worst.get(name, 0.0), r)
        print(f"ssd 13a: {name} {tuple(c[0].shape)} and the gradients of "
              f"inputs {list(grad_idx)}: {r:.3f} of the tolerance (rtol "
              f"{SSD_OP_TOL[0]:g} + {SSD_OP_TOL[1]:g}*max|ref|)")
        check(r <= 1, f"{name}: card and CPU disagree")
    return worst


def ssd_state(mod):
    """({parameter}, {momentum by parameter}) as numpy."""
    args, _ = mod.get_params()
    names = mod._exec_group.param_names
    return ({n: v.asnumpy() for n, v in args.items()},
            {names[i]: m.asnumpy() for i, m in mod._updater.states.items()})


def ssd_module(mx, sym, ctx, batch, image):
    mod = mx.mod.Module(sym, context=ctx, data_names=("data",),
                        label_names=("label",))
    mod.bind([("data", (batch, 3, image, image))],
             [("label", (batch, 3, 5))])
    return mod


def ssd_steps(mx, sym, ctx, batches, teacher=None, dtype="float32"):
    """Phase 13b: the config's steps (SSD_OPT, rescale 1/batch) in
    `dtype` on `ctx` from Xavier parameters under mx.random.seed(SEED),
    on `batches`, through `fit_step` with the example's metric (the
    per-batch path): each step's readouts and the states before the
    first and after each; with `teacher`, step k starts from the
    teacher's state before it."""
    batch = batches[0].data[0].shape[0]
    mod = ssd_module(mx, sym, ctx, batch, SSD_CFG["image"])
    if dtype == "float64":
        as_float64(mod)
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        SSD_OPT, rescale_grad=1.0 / batch))
    reads, states = [], [ssd_state(mod)]
    for k, b in enumerate(batches):
        if teacher is not None and k:
            params, moms = teacher[k]
            mod.set_params(params, {})
            for i, n in enumerate(mod._exec_group.param_names):
                mod._updater.states[i]._set_data(moms[n])
        metric = ssd_metric(mx)
        mod.fit_step(b, metric)
        reads.append(metric.get()[1])
        states.append(ssd_state(mod))
    return reads, states


def ssd_ratio(got, ref, skip=()):
    """`param_ratio`, with an array that is all zeros in `ref` (a
    momentum whose gradient was 0) held to |got| <= 1e-12 instead."""
    zero = {n for n, c in ref.items() if not np.abs(c).max()}
    worst = param_ratio(got, {n: c for n, c in ref.items()
                              if n not in zero}, skip)
    return max([worst] + [(float(np.abs(got[n]).max() / 1e-12), n)
                          for n in zero if not n.startswith(skip)])


def ssd_pool_routes(params, x, ctx):
    """Which element wins each window of the backbone's five 2x2
    max-pools at these parameters and images, on `ctx`, by the torch
    calls the port makes (3x3 convs, relu)."""
    import torch.nn.functional as F
    dev = ctx.torch_device
    h = torch.from_numpy(x).to(dev, torch.from_numpy(
        params["b1_conv0_weight"]).dtype)
    routes = []
    for blk, convs in (("b1", 2), ("b2", 2), ("b3", 3), ("b4", 3),
                       ("b5", 3)):
        for i in range(convs):
            w = torch.from_numpy(params[f"{blk}_conv{i}_weight"]).to(dev)
            b = torch.from_numpy(params[f"{blk}_conv{i}_bias"]).to(dev)
            h = torch.relu(F.conv2d(h, w, b, padding=1))
        h, idx = F.max_pool2d(h, 2, 2, return_indices=True)
        routes.append(idx.cpu())
    return routes


def ssd_flipped(mx, params, x):
    """The deepest backbone pool (1-5) with a window whose winner
    differs between the CPU and the card at `params` on `x`, 0 for
    none; and the count of such windows."""
    cpu = ssd_pool_routes(params, x, mx.cpu())
    gpu = ssd_pool_routes(params, x, mx.gpu(0))
    counts = [int((c != g).sum()) for c, g in zip(cpu, gpu)]
    deepest = max([k + 1 for k, n in enumerate(counts) if n] or [0])
    return deepest, sum(counts)


def ssd_parity(mx, sym, dtype="float64"):
    """Phase 13b: SSD_PARITY steps of the full-width SSD at 128 in
    `dtype` (TF32 off) on the card against the CPU, from the same Xavier
    parameters and batches: the readouts (CrossEntropy, SmoothL1) of
    every free-running step within rtol 1e-3; each card step from the
    CPU's state: parameters and momenta within PARITY_TOL.  A step where
    a backbone max-pool window flips between the devices excuses the
    blocks up to that pool (printed, not held), as phase 6 excuses
    lenet's convolutions.  Held in float64: in fp32 the gradients of the
    early convolutions part between the devices by more than the
    tolerance (13b's fp32 lane, printed, not held)."""
    batch, steps = SSD_PARITY
    it = ssd_iter(mx, batch * steps, batch)
    batches = [b for _, b in zip(range(steps), it)]
    xs = [b.data[0].asnumpy() for b in batches]
    t0 = time.perf_counter()
    cpu_reads, cpu = ssd_steps(mx, sym, mx.cpu(), batches, dtype=dtype)
    t_cpu = time.perf_counter() - t0
    gpu_reads, gpu = ssd_steps(mx, sym, mx.gpu(0), batches, dtype=dtype)
    _, forced = ssd_steps(mx, sym, mx.gpu(0), batches, teacher=cpu,
                          dtype=dtype)
    read_err = max(abs(g - c) / abs(c) for gr, cr in zip(gpu_reads,
                                                         cpu_reads)
                   for g, c in zip(gr, cr))
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, x in enumerate(xs):
        deepest, n = ssd_flipped(mx, cpu[k][0], x)
        skip = tuple(f"b{i}_" for i in range(1, deepest + 1))
        after, ref = forced[k + 1], cpu[k + 1]
        held = max([held] + [ssd_ratio(a, r, skip)
                             for a, r in zip(after, ref)])
        if n:
            flips.append(f"step {k + 1}: {n} (blocks 1-{deepest})")
            excused = max([excused] + [ssd_ratio(a, r)
                                       for a, r in zip(after, ref)])
    ok = read_err <= PARITY_TOL[0] and held[0] <= 1 and \
        all(np.isfinite(v) for r in gpu_reads for v in r)
    gated = dtype == "float64"
    verdict = ("ok" if ok else "FAIL") if gated else "(not held)"
    print(f"ssd 13b: {steps} steps of the full-width SSD at batch {batch}, "
          f"{SSD_CFG['image']}x{SSD_CFG['image']}, {dtype} (TF32 off), "
          f"card vs CPU (CPU {t_cpu:.1f} s): CrossEntropy "
          f"{' '.join(f'{r[0]:.6f}' for r in gpu_reads)}, SmoothL1 "
          f"{' '.join(f'{r[1]:.6f}' for r in gpu_reads)}; max relative "
          f"readout err {read_err:.2e} (rtol {PARITY_TOL[0]:g}); each step "
          f"from the CPU's state: parameters and momenta at "
          f"{held[0]:.3f} of the tolerance (worst {held[1]}) (rtol "
          f"{PARITY_TOL[0]:g}, atol {PARITY_TOL[1]:g}*max|array|) {verdict}")
    note = f"; at those steps the excused blocks at {excused[0]:.3f} of " \
        f"the tolerance (worst {excused[1]}), not held" if flips else ""
    print(f"ssd 13b: {dtype}: max-pool windows flipped between the CPU and "
          f"the card from the CPU's state: {', '.join(flips) or 'none'}"
          f"{note}")
    if gated:
        check(ok, "ssd: the card's float64 steps disagree with the CPU's")
    return {"worst": held[0], "read_err": read_err, "cpu_s": t_cpu,
            "flips": len(flips)}


class _BatchClock:
    """Batch-end callback: the time of every batch end and the metric at
    each epoch's last batch."""

    def __init__(self, per_epoch):
        self.per_epoch = per_epoch
        self.times, self.epochs = [], []

    def __call__(self, param):
        self.times.append(time.perf_counter())
        if param.nbatch == self.per_epoch - 1:
            self.epochs.append(dict(zip(*param.eval_metric.get())))


def ssd_fit(mx, sym, card, on_device=False):
    """Phase 13c: the config through Module.fit at the example's
    defaults; images/s over epochs 2-3, the median step ms, peak memory,
    batches the fused step declined; CrossEntropy falling from epoch 1
    to 3; then the example's decode of one batch.  Returns (module,
    iterator, numbers)."""
    cfg = SSD_CFG
    batch, per_epoch = cfg["batch"], cfg["n"] // cfg["batch"]
    train = ssd_iter(mx, cfg["n"], batch, cfg["image"], cfg["classes"])
    mod = mx.mod.Module(sym, context=mx.gpu(0), data_names=("data",),
                        label_names=("label",))
    clock = _BatchClock(per_epoch)
    metric = ssd_metric(mx, on_device)
    torch.cuda.reset_peak_memory_stats()
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(train, num_epoch=cfg["epochs"], optimizer="sgd",
            optimizer_params=dict(SSD_OPT, rescale_grad=1.0 / batch),
            initializer=mx.initializer.Xavier(), eval_metric=metric,
            batch_end_callback=[mx.callback.Speedometer(batch, 10), clock])
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    total_s = t_end - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t = clock.times
    steps_ms = np.diff(t[per_epoch:]) * 1e3
    images_s = batch * (len(t) - per_epoch) / (t_end - t[per_epoch - 1])
    batches = cfg["epochs"] * per_epoch
    declined = batches - mod._fused_step.steps
    ce = [e["CrossEntropy"] for e in clock.epochs]
    l1 = [e["SmoothL1"] for e in clock.epochs]
    lane = "the metric on the card (device_update)" if on_device else \
        "the example's metric"
    print(f"ssd 13c: config #5 through Module.fit with {lane}: "
          f"{cfg['epochs']} epochs of {per_epoch} batches of {batch} at "
          f"{cfg['image']}x{cfg['image']}, {total_s:.1f} s; epochs 2-3 "
          f"{images_s:.1f} images/s, step median "
          f"{statistics.median(steps_ms):.2f} ms; peak "
          f"{peak:.2f} GiB; the fused step declined {declined} of "
          f"{batches} batches; CrossEntropy by epoch "
          f"{' '.join(f'{v:.4f}' for v in ce)}, SmoothL1 "
          f"{' '.join(f'{v:.5f}' for v in l1)} [{card}]")
    check(len(ce) == cfg["epochs"] and ce[-1] < ce[0] and
          all(np.isfinite(ce + l1)), "ssd 13c: CrossEntropy did not fall "
          "from epoch 1 to the last")
    return mod, train, {"images_s": images_s,
                        "step_ms": statistics.median(steps_ms),
                        "peak_gib": peak, "declined": declined,
                        "ce": ce, "l1": l1, "total_s": total_s}


def ssd_decode(mx, mod, train):
    """train_ssd.py's closing decode (:197-205): the first batch after a
    reset, forward in inference mode, detections kept."""
    train.reset()
    batch = next(iter(train))
    mod.forward(batch, is_train=False)
    det = mod.get_outputs()[3].asnumpy()
    kept = int((det[:, :, 0] >= 0).sum())
    print(f"ssd 13c: decoded {kept} detections on a {det.shape[0]}-image "
          f"batch ({det.shape[1]} anchors an image); classes "
          f"{sorted(set(det[det[:, :, 0] >= 0][:, 0].astype(int)))}")
    check(kept >= 1 and np.isfinite(det).all(), "ssd 13c: the decode kept "
          "no detection")
    return kept


def ssd300_lane(mx, sym, card):
    """Phase 13c: the same symbol at 300x300 (SSD300's input), batch 16,
    on one resident synthetic batch: SSD300["warm"] steps, then
    SSD300["timed"] timed (per-batch path with the example's metric):
    images/s, step ms, peak memory.  Not gated.  Returns (module, batch,
    numbers)."""
    cfg = SSD300
    batch, image = cfg["batch"], cfg["image"]
    x, y = ssd_synthetic(batch, image)
    one = mx.io.DataBatch([mx.nd.array(x, ctx=mx.gpu(0))],
                          [mx.nd.array(y, ctx=mx.gpu(0))], pad=0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mod = ssd_module(mx, sym, mx.gpu(0), batch, image)
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(
        SSD_OPT, rescale_grad=1.0 / batch))
    metric = ssd_metric(mx)
    for _ in range(cfg["warm"]):
        mod.fit_step(one, metric)
    torch.cuda.synchronize()
    times = [time.perf_counter()]
    for _ in range(cfg["timed"]):
        mod.fit_step(one, metric)
        torch.cuda.synchronize()
        times.append(time.perf_counter())
    steps_ms = np.diff(times) * 1e3
    out = {"images_s": batch * cfg["timed"] / (times[-1] - times[0]),
           "step_ms": statistics.median(steps_ms),
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "anchors": mod.get_outputs()[3].shape[1]}
    ce, l1 = metric.get()[1]
    print(f"ssd 13c: the symbol at {image}x{image} (SSD300's input, "
          f"{out['anchors']} anchors), batch {batch}, resident batch, "
          f"{cfg['warm']} warm + {cfg['timed']} timed steps: "
          f"{out['images_s']:.1f} images/s, step median "
          f"{out['step_ms']:.2f} ms, peak {out['peak_gib']:.2f} GiB; "
          f"CrossEntropy {ce:.4f} [{card}]")
    check(np.isfinite([ce, l1]).all(), "ssd 13c: the 300x300 lane's "
          "readouts are not finite")
    return mod, one, out


def ssd_op_alone(mx, card, image, batch):
    """Phase 13d: MultiBoxTarget and MultiBoxDetection alone on the card
    at `image` (N anchors), batch `batch`: host ms a call (it returns
    after the NMS rounds' host reads), device ms and kernel launches
    under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    from incubator_mxnet_tpu_torch.ops.detection import greedy_nms
    prob, loc, anchors, labels = (t.to(SSD_DEV) for t in ssd_head_inputs(
        mx, image, batch))
    calls = {
        "MultiBoxTarget": lambda: op_fn(
            "MultiBoxTarget", {"overlap_threshold": 0.5}, anchors, labels,
            prob),
        "MultiBoxDetection": lambda: op_fn(
            "MultiBoxDetection", {"nms_threshold": 0.45}, prob, loc,
            anchors)}
    out = {}
    for name, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(e.time_range.end - e.time_range.start
                  for e in kernels) / 1e3
        launches = sum(1 for e in kernels if "Memcpy" not in e.name and
                       "Memset" not in e.name)
        rounds = greedy_nms.rounds if name == "MultiBoxDetection" else 0
        n = anchors.shape[1]
        out[name] = {"host_ms": statistics.median(host), "device_ms": dev,
                     "launches": launches, "rounds": rounds, "n": n}
        extra = f", {rounds} NMS rounds" if rounds else ""
        print(f"ssd 13d: {name} alone at N={n}, batch {batch}: "
              f"{statistics.median(host):.3f} ms of host time a call, "
              f"{dev:.3f} ms of device time, {launches} kernel launches"
              f"{extra} [{card}]")
    return out


def ssd_rec(mx, tmp):
    """Phase 13e: SSD_REC synthetic rectangle images at 128x128 (the
    SyntheticDetIter pattern, mapped to uint8) packed as JPEG by the
    port's recordio, labels [A=2, B=5, objects...]; returns (.rec path,
    the packed labels (n, 3, 5), -1 padded)."""
    from incubator_mxnet_tpu_torch import recordio
    x, y = ssd_synthetic(SSD_REC, SSD_CFG["image"])
    imgs = np.clip(x.transpose(0, 2, 3, 1) * 100 + 60, 0, 255).astype(
        np.uint8)
    rec = os.path.join(tmp, "det.rec")
    w = recordio.MXIndexedRecordIO(os.path.join(tmp, "det.idx"), rec, "w")
    for i in range(SSD_REC):
        objs = y[i][y[i, :, 0] >= 0]
        label = np.concatenate([[2.0, 5.0], objs.ravel()]).astype("f4")
        w.write_idx(i, recordio.pack_img(recordio.IRHeader(0, label, i, 0),
                                         imgs[i], img_fmt=".jpg"))
    w.close()
    return rec, y


def ssd_data_path(mx, sym, card, workdir):
    """Phase 13e: the pack read back through ImageDetIter with no
    augmenter, labels equal to the packed ones and images to the
    records' decodes, bit for bit; then one epoch of the SSD from the
    pack with CreateDetAugmenter(rand_crop=0.5, rand_mirror=True, mean,
    std) through Module.fit: images/s, the readouts finite."""
    from incubator_mxnet_tpu_torch import image, recordio
    cfg = SSD_CFG
    shape = (3, cfg["image"], cfg["image"])
    out = {}
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        t0 = time.perf_counter()
        rec, labels = ssd_rec(mx, tmp)
        size = os.path.getsize(rec)
        it = image.ImageDetIter(cfg["batch"], shape, path_imgrec=rec,
                                aug_list=[], max_objects=3)
        reader = recordio.MXIndexedRecordIO(
            os.path.join(tmp, "det.idx"), rec, "r")
        seen = 0
        for b in it:
            got_x, got_y = b.data[0].asnumpy(), b.label[0].asnumpy()
            for k in range(cfg["batch"] - b.pad):
                _, payload = recordio.unpack(reader.read_idx(seen + k))
                want = image.imdecode(payload).asnumpy().transpose(2, 0, 1)
                check(np.array_equal(got_x[k], want.astype("f4")),
                      f"13e: image {seen + k} differs from its decode")
            check(np.array_equal(got_y[:cfg["batch"] - b.pad],
                                 labels[seen:seen + cfg["batch"] - b.pad]),
                  "13e: ImageDetIter's labels differ from the packed ones")
            seen += cfg["batch"] - b.pad
        reader.close()
        check(seen == SSD_REC, f"13e: read {seen} of {SSD_REC} images")
        print(f"ssd 13e: {SSD_REC} images packed as JPEG ({size / 1e6:.2f} "
              f"MB) with [2, 5, objects] labels, read back through "
              f"ImageDetIter: labels and images equal, bit for bit "
              f"({time.perf_counter() - t0:.1f} s)")
        random.seed(SEED)
        train = image.ImageDetIter(
            cfg["batch"], shape, path_imgrec=rec, shuffle=True,
            max_objects=3, rand_crop=0.5, rand_mirror=True, mean=True,
            std=True)
        mod = mx.mod.Module(sym, context=mx.gpu(0), data_names=("data",),
                            label_names=("label",))
        per_epoch = SSD_REC // cfg["batch"]
        clock = _BatchClock(per_epoch)
        metric = ssd_metric(mx)
        mx.random.seed(SEED)
        t0 = time.perf_counter()
        mod.fit(train, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(SSD_OPT,
                                      rescale_grad=1.0 / cfg["batch"]),
                initializer=mx.initializer.Xavier(), eval_metric=metric,
                batch_end_callback=clock)
        wall = time.perf_counter() - t0
        ce, l1 = metric.get()[1]
        out["images_s"] = SSD_REC / wall
        out["steady_images_s"] = cfg["batch"] * (len(clock.times) - 1) / (
            clock.times[-1] - clock.times[0])
        print(f"ssd 13e: one epoch from the pack (CreateDetAugmenter "
              f"rand_crop 0.5, rand_mirror, mean, std; {per_epoch} batches "
              f"of {cfg['batch']}) through Module.fit: "
              f"{out['images_s']:.1f} images/s over the epoch, "
              f"{out['steady_images_s']:.1f} after its first batch; "
              f"CrossEntropy {ce:.4f}, SmoothL1 {l1:.5f} [{card}]")
        check(np.isfinite([ce, l1]).all(), "13e: the readouts are not "
              "finite")
    return out


def ssd_phase(card, workdir):
    """Phase 13; returns the numbers of the summary line.  The counts of
    K1, K2 and K3 are set to 0 before it and must stay 0: no TPU kernel
    is on this path (convolutions only; nothing runs attention)."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    counted = (fc_relu, flash_fwd, flash_fwd_stream)
    for wrapper in counted:
        wrapper.launches = 0
    sym = ssd_symbol(mx, SSD_CFG["classes"])
    img = SSD_CFG["image"]
    args, outs, _ = sym.infer_shape(data=(SSD_CFG["batch"], 3, img, img),
                                    label=(SSD_CFG["batch"], 3, 5))
    learned = [a for n, a in zip(sym.list_arguments(), args)
               if n not in ("data", "label")]
    print(f"ssd: train_ssd.py's SSD-VGG16 on mx.sym: {len(learned)} learned "
          f"arguments of {sum(math.prod(a) for a in learned)} values; "
          f"outputs {outs}")
    out = {}
    t0 = time.perf_counter()
    out["ops"] = ssd_ops(mx, card)
    print(f"phase 13a: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["parity32"] = ssd_parity(mx, sym, "float32")
    out["parity"] = ssd_parity(mx, sym, "float64")
    print(f"phase 13b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    mod, train, out["fit"] = ssd_fit(mx, sym, card)
    out["kept"] = ssd_decode(mx, mod, train)
    batch = next(iter(train))
    metric = ssd_metric(mx)
    out["profile"] = profile_one_step(
        lambda: mod.fit_step(batch, metric), card, "ssd 13d 128",
        SSD_CFG["batch"], dtype="fp32", classes=SSD_OP_CLASSES)
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    out["fit_device"] = ssd_fit(mx, sym, card, on_device=True)[2]
    gc.collect()
    torch.cuda.empty_cache()
    mod300, one, out["ssd300"] = ssd300_lane(mx, sym, card)
    metric = ssd_metric(mx)
    out["profile300"] = profile_one_step(
        lambda: mod300.fit_step(one, metric), card, "ssd 13d 300",
        SSD300["batch"], dtype="fp32", classes=SSD_OP_CLASSES)
    del mod300, one
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13c: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["alone"] = {img: ssd_op_alone(mx, card, img, SSD_CFG["batch"])
                    for img in (SSD_CFG["image"], SSD300["image"])}
    print(f"phase 13d: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out["rec"] = ssd_data_path(mx, sym, card, workdir)
    print(f"phase 13e: {time.perf_counter() - t0:.1f} s")
    launches = [w.launches for w in counted]
    print(f"ssd: K1/K2/K3 launches over phase 13: {launches} (no TPU "
          f"kernel is on this path)")
    check(launches == [0, 0, 0], "a K1/K2/K3 kernel ran on config #5's path")
    return out


# -- phase 14d: examples/recommender/wide_deep.py, copied onto the port ------

# the example's defaults (wide_deep.py:72-79, its table's cache rows from
# MXNET_EMBED_CACHE_ROWS)
WD_CFG = dict(rows=200_000, dim=16, shards=2, epochs=2, batch=64,
              samples=4096, lr=0.1, cache_rows=4096)
WD_SLOTS = 2   # (user id, item id)


def wd_clicks(n, num_rows, rng):
    """wide_deep.py `synthetic_clicks` (:51): power-law (user, item) pairs
    and a planted preference rule."""
    probs = 1.0 / np.arange(1, num_rows + 1) ** 1.1
    probs /= probs.sum()
    ids = rng.choice(num_rows, size=(n, WD_SLOTS), p=probs).astype(np.int64)
    dense = rng.randn(n, 4).astype(np.float32)
    label = ((ids[:, 0] + ids[:, 1]) % 3 == 0).astype(np.float32)
    return ids, dense, label


def wd_tower(mx, embed_width, dense_width, hidden=32):
    """wide_deep.py `tower` (:61): wide (linear over dense) + deep (MLP
    over the embeddings)."""
    emb = mx.sym.Variable("emb")
    den = mx.sym.Variable("dense")
    deep = mx.sym.FullyConnected(emb, num_hidden=hidden, name="deep1")
    deep = mx.sym.Activation(deep, act_type="relu")
    wide = mx.sym.FullyConnected(den, num_hidden=hidden, name="wide1")
    both = deep + wide
    out = mx.sym.FullyConnected(both, num_hidden=2, name="head")
    return mx.sym.SoftmaxOutput(out, name="softmax")


def wide_deep(mx, cfg, ctx, arg_params=None, batch_end=None, epochs=None):
    """wide_deep.py `main` (:72) on the port at `cfg`, the tower and the
    table's cache on `ctx`: `cfg["shards"]` parameter servers as threads
    of this process, the `ShardedEmbedding` on them (seed 7, SGD at
    ``lr / batch`` on the shards), the `EmbeddingFitAdapter`, the tower
    bound with ``inputs_need_grad`` and fitted with the row-sparse push
    at each batch's end.  `arg_params` (numpy) sets the tower's start,
    else the example's default initializer draws it.  -> dict of the
    module, table, adapter and servers (the caller closes the table and
    shuts the servers down: `wide_deep_close`)."""
    from incubator_mxnet_tpu_torch import embedding as mxembed
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    servers = [ParameterServer(num_workers=1).start()
               for _ in range(cfg["shards"])]
    run = {"servers": servers}
    try:
        table = mxembed.ShardedEmbedding(
            "user_item", cfg["rows"], cfg["dim"],
            [("127.0.0.1", s.port) for s in servers], seed=7,
            cache_rows=cfg["cache_rows"], ctx=ctx,
            optimizer=mx.optimizer.SGD(learning_rate=cfg["lr"],
                                       rescale_grad=1.0 / cfg["batch"]))
        run["table"] = table
        ids, dense, label = wd_clicks(cfg["samples"], cfg["rows"],
                                      np.random.RandomState(0))
        base = mx.io.NDArrayIter({"emb": ids.astype(np.float32),
                                  "dense": dense},
                                 {"softmax_label": label},
                                 batch_size=cfg["batch"])
        adapter = mxembed.EmbeddingFitAdapter(table, base, id_field=0)
        mod = mx.mod.Module(wd_tower(mx, WD_SLOTS * cfg["dim"], 4),
                            data_names=("emb", "dense"),
                            label_names=("softmax_label",), context=ctx)
        mod.bind(data_shapes=adapter.provide_data,
                 label_shapes=adapter.provide_label,
                 for_training=True, inputs_need_grad=True)
        push = adapter.make_callback(mod)
        callbacks = [push] + ([batch_end] if batch_end else [])
        mod.fit(adapter, num_epoch=epochs or cfg["epochs"], optimizer="sgd",
                optimizer_params={"learning_rate": cfg["lr"],
                                  "rescale_grad": 1.0 / cfg["batch"]},
                arg_params=None if arg_params is None else
                {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                 arg_params.items()},
                batch_end_callback=callbacks, eval_metric="acc")
        run.update(mod=mod, adapter=adapter)
        return run
    except BaseException:
        wide_deep_close(run)
        raise


def wide_deep_close(run):
    """Close a `wide_deep` run's table and shut its servers down."""
    if run.get("table") is not None:
        run["table"].close()
    for s in run["servers"]:
        s.shutdown()


# -- phase 14: the kvstore, the parameter server, wide_deep.py ---------------

KV_OPT_RTOL = 1e-6           # 14a: optimizer results, card vs CPU (rtol,
                             # and atol * max|array|)
DP_TOL = (1e-5, 1e-6)        # 14b/14c: loss rtol; rtol, atol * max|array|
DP_2BIT = {"type": "2bit", "threshold": 0.5}
DP_2BIT_TOL = (1e-4, 1e-5)   # 14b compressed, card vs CPU
DP_NEAR = 1e-5               # 14b: |g + residual| within this of the
                             # threshold (relative) is a near tie
DIST_WORKERS, DIST_STEPS = 2, 8   # 14c: batch 64 / 2 workers = 32 each
WD_TOL = (1e-4, 1e-5)        # 14d: loss rtol; rtol, atol * max|array|
WD_PARAMS_SEED = 1


def kv_cases(mx, ctx, cpu_store=False):
    """tests/test_kvstore.py's single-process cases with every value on
    `ctx` (a ``device`` store on the CPU, `cpu_store`, is the reference's
    host twin); -> {case: numpy results}."""
    nd = mx.nd
    rng = np.random.RandomState(SEED)

    def arr(x):
        return nd.array(np.asarray(x, np.float32), ctx=ctx)

    def store(kind):
        kv = mx.kv.create(kind)
        if cpu_store:
            kv._store_ctx = mx.cpu()
        return kv

    out = {}
    shape = (64, 33)
    vals = [rng.randn(*shape).astype("f4") for _ in range(5)]
    for kind in ("local", "device"):
        kv = store(kind)
        kv.init(3, arr(np.ones(shape)))
        o = nd.zeros(shape, ctx=ctx)
        kv.pull(3, out=o)
        kv.push(3, arr(vals[0]))
        kv.pull(3, out=o)
        out[f"{kind} push/pull"] = o.asnumpy()
        kv.init(4, arr(np.zeros(shape)))
        kv.push(4, [arr(vals[0]), arr(vals[1])])     # two values, one card
        outs = [nd.zeros(shape, ctx=ctx) for _ in range(2)]
        kv.pull(4, out=outs)
        out[f"{kind} list of two"] = np.stack([x.asnumpy() for x in outs])
        keys = ["a", "b", "c"]
        kv.init(keys, [arr(np.zeros(shape))] * 3)
        kv.push(keys, [[arr(v), arr(w)] for v, w in zip(vals, vals[2:])])
        outs = [nd.zeros(shape, ctx=ctx) for _ in keys]
        kv.pull(keys, out=outs)
        out[f"{kind} multi-key push"] = np.stack([x.asnumpy() for x in outs])
        o = nd.zeros(shape, ctx=ctx)
        kv.pushpull(3, [arr(vals[3]), arr(vals[4])], out=o)
        out[f"{kind} pushpull"] = o.asnumpy()
        o = nd.zeros(shape, ctx=ctx)
        kv.row_sparse_pull(3, out=o, row_ids=arr([5, 0, 17]))
        out[f"{kind} row_sparse_pull"] = o.asnumpy()
    kv = store("device")
    kv.init(3, arr(np.ones(shape)))
    kv.set_updater(lambda key, recv, stored: stored.__iadd__(recv * 2))
    kv.push(3, [arr(vals[0]), arr(vals[1])])
    o = nd.zeros(shape, ctx=ctx)
    kv.pull(3, out=o)
    out["set_updater"] = o.asnumpy()
    for name, opt in (("sgd", mx.optimizer.SGD(learning_rate=0.1,
                                                momentum=0.9, wd=1e-4)),
                      ("adam", mx.optimizer.Adam(learning_rate=0.01))):
        kv = store("device")
        kv.init("w", arr(vals[4]))
        kv.set_optimizer(opt)
        for v in vals:
            kv.push("w", [arr(v), arr(v * 0.5)])
        kv.pull("w", out=o)
        out[f"set_optimizer {name}"] = o.asnumpy()
    kv = store("device")
    kv.set_gradient_compression(DP_2BIT)
    kv.init("g", arr(np.zeros(shape)))
    codes, resid = [], []
    for _ in range(20):
        kv.push("g", [arr(rng.randn(*shape) * 0.3) for _ in range(2)])
        kv.pull("g", out=o)
        codes.append(o.asnumpy())
        resid.append(kv._residuals["g"].cpu().numpy())
    out["2-bit codes over 20 pushes"] = np.stack(codes)
    out["2-bit residuals over 20 pushes"] = np.stack(resid)
    return out


def kv_card(mx, card):
    """14a: each case on the card against the same calls on the CPU;
    reductions and 2-bit codes equal bit for bit, optimizer results
    within rtol KV_OPT_RTOL."""
    t0 = time.perf_counter()
    got = kv_cases(mx, mx.gpu(0))
    want = kv_cases(mx, mx.cpu(), cpu_store=True)
    worst = 0.0
    for name, ref in want.items():
        g = got[name]
        if name.startswith("set_optimizer"):
            bound = KV_OPT_RTOL * (np.abs(ref) + np.abs(ref).max())
            err = float((np.abs(g - ref) / bound).max())
            worst = max(worst, err)
            ok = err <= 1
            what = (f"at {err:.3f} of the tolerance (rtol {KV_OPT_RTOL:g}, "
                    f"atol {KV_OPT_RTOL:g}*max|ref|)")
        else:
            ok = np.array_equal(g, ref)
            what = "bit for bit" if ok else \
                f"max |diff| {np.abs(g - ref).max():.3e}"
        print(f"kvstore 14a: {name}: {what} {'ok' if ok else 'FAIL'}")
        check(ok, f"14a {name}: the card disagrees with the CPU")
    print(f"phase 14a: {len(want)} cases in "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return worst


def dp_init(mx, sym):
    """Xavier parameters of train_mnist's mlp drawn on the CPU under
    mx.random.seed(SEED), as numpy."""
    mod = mx.mod.Module(sym, context=mx.cpu())
    mod.bind([("data", (TRAIN_BATCH, 1, 28, 28))],
             [("softmax_label", (TRAIN_BATCH,))])
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


def dp_steps(mx, sym, contexts, batches, init, kvstore, compression=None,
             mesh=None):
    """Module steps (forward_backward, update) over `contexts` from `init`:
    the loss of each step, the parameters and the momenta after the last
    (from the store's updater when the update runs there), and each
    step's 2-bit (g + residual, code) per key under `compression`; a
    `mesh` spec goes to `init_optimizer`."""
    mod = mx.mod.Module(sym, context=contexts,
                        compression_params=compression)
    mod.bind([("data", (TRAIN_BATCH, 1, 28, 28))],
             [("softmax_label", (TRAIN_BATCH,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in init.items()})
    mod.init_optimizer(kvstore=kvstore, optimizer="sgd",
                       optimizer_params={"learning_rate": TRAIN_LR,
                                         "momentum": TRAIN_MOMENTUM},
                       **({} if mesh is None else {"mesh": mesh}))
    codes = []
    if compression is not None:
        kv = mod._kvstore
        orig = kv._compress

        def spy(sk, merged):
            r = kv._residuals.get(sk)
            g = merged.asnumpy() + (0 if r is None else r.cpu().numpy())
            q = orig(sk, merged)
            codes[-1][sk] = (g, q.asnumpy())
            return q
        kv._compress = spy
    losses = []
    for batch in batches:
        codes.append({})
        mod.forward_backward(batch)
        mod.update()
        losses.append(cross_entropy(mod.get_outputs()[0], batch.label[0]))
    names = mod._exec_group.param_names
    if mod._update_on_kvstore:
        moms = {n: mod._kvstore._updater.states[n].asnumpy() for n in names}
    else:
        ndev = len(contexts)
        moms = {n: mod._updater.states[i * ndev].asnumpy()
                for i, n in enumerate(names)}
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return mod, losses, params, moms, codes


def held_worst(got, ref, tol, keep=None):
    """The largest |got - ref| / (rtol |ref| + atol max|ref|) over the
    arrays of `ref` (the elements `keep` selects), and its name."""
    rtol, atol = tol
    worst, at = -1.0, "none"
    for n, r in ref.items():
        m = np.ones(r.shape, bool) if keep is None else keep[n]
        if not m.any():
            continue
        bound = rtol * np.abs(r) + atol * np.abs(r).max() + 1e-30
        v = float((np.abs(got[n] - r) / bound)[m].max())
        if v > worst:
            worst, at = v, n
    return max(worst, 0.0), at


def dp_free(mx, sym, card):
    """14b free running: 8 steps on [gpu(0), gpu(0)] through
    kvstore='device' against the one-context unfused step on the card,
    from the same parameters and batches.  Returns K1's launches."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    train, _ = mnist_iters(mx)
    batches = [next(train) for _ in range(PARITY_STEPS)]
    init = dp_init(mx, sym)
    _, ref_loss, ref_p, ref_m, _ = dp_steps(mx, sym, [mx.gpu(0)], batches,
                                            init, "local")
    fc_relu.launches = 0
    mod, loss, p, m, _ = dp_steps(mx, sym, [mx.gpu(0), mx.gpu(0)], batches,
                                  init, "device")
    launches = fc_relu.launches
    check(len(mod._exec_group.execs) == 2 and mod._fused_step is None and
          mod._update_on_kvstore, "14b: not two executors updating on the "
          "kvstore")
    a = mod._exec_group.param_arrays[0]
    check(a[0].data.data_ptr() != a[1].data.data_ptr(),
          "14b: the two contexts share their arrays")
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(loss, ref_loss))
    pw, pn = held_worst(p, ref_p, DP_TOL)
    mw, mn = held_worst(m, ref_m, DP_TOL)
    ok = loss_err <= DP_TOL[0] and pw <= 1 and mw <= 1 and \
        launches == 4 * PARITY_STEPS
    print(f"dp 14b free running: {PARITY_STEPS} steps on [gpu(0), gpu(0)], "
          f"kvstore='device' (update on the store), vs one context: loss "
          f"{' '.join(f'{v:.4f}' for v in loss)}; max rel loss err "
          f"{loss_err:.2e} (rtol {DP_TOL[0]:g}); parameters at {pw:.3f} "
          f"(worst {pn}), momenta at {mw:.3f} (worst {mn}) of the "
          f"tolerance (rtol {DP_TOL[0]:g}, atol {DP_TOL[1]:g}*max|array|); "
          f"K1 launches {launches} (4 a step) {'ok' if ok else 'FAIL'} "
          f"[{card}]")
    check(ok, "14b: two contexts on the card disagree with one")
    return launches


def dp_compressed(mx, sym, card):
    """14b compressed: the 2-context lane with 2-bit compression on the
    card against the same lane on the CPU (a local store there): codes
    equal outside counted near ties; parameters within DP_2BIT_TOL where
    no code differed."""
    train, _ = mnist_iters(mx)
    batches = [next(train) for _ in range(PARITY_STEPS)]
    init = dp_init(mx, sym)
    _, closs, cp, _, ccodes = dp_steps(
        mx, sym, [mx.cpu(), mx.cpu()], batches, init, "local", DP_2BIT)
    mod, gloss, gp, _, gcodes = dp_steps(
        mx, sym, [mx.gpu(0), mx.gpu(0)], batches, init, "device", DP_2BIT)
    check(mod._update_on_kvstore and len(mod._kvstore._residuals) == 6,
          "14b compressed: not updating on the kvstore, one residual a key")
    thr = DP_2BIT["threshold"]
    flipped = {k: np.zeros(v.shape, bool) for k, v in init.items()}
    ties = far = nonzero = 0
    for step_c, step_g in zip(ccodes, gcodes):
        for k, (cg, cq) in step_c.items():
            _, gq = step_g[k]
            near = np.abs(np.abs(cg) - thr) <= DP_NEAR * thr
            differ = cq != gq
            ties += int(near.sum())
            far += int((differ & ~near).sum())
            flipped[k] |= differ.reshape(flipped[k].shape)
            nonzero += int((cq != 0).sum())
    keep = {k: ~f for k, f in flipped.items()}
    pw, pn = held_worst(gp, cp, DP_2BIT_TOL, keep)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gloss, closs))
    n_flip = sum(int(f.sum()) for f in flipped.values())
    ok = far == 0 and pw <= 1
    print(f"dp 14b compressed (2bit, threshold {thr}): {PARITY_STEPS} steps "
          f"card vs CPU: {nonzero} nonzero codes, {ties} near ties "
          f"(|g+r| within {DP_NEAR:g} of the threshold), {n_flip} codes "
          f"differ at near ties, {far} elsewhere; parameters where no code "
          f"differed at {pw:.3f} of the tolerance (worst {pn}; rtol "
          f"{DP_2BIT_TOL[0]:g}, atol {DP_2BIT_TOL[1]:g}*max|array|); loss "
          f"max rel diff {loss_err:.2e} (printed) {'ok' if ok else 'FAIL'} "
          f"[{card}]")
    check(ok, "14b compressed: the card's codes or parameters disagree")
    return {"ties": ties, "flipped": n_flip}


def dp_fit(mx, sym, card):
    """14b full fit: train_mnist's defaults on [gpu(0), gpu(0)] through
    kvstore='device', TRAIN_EPOCHS epochs; validation accuracy > 0.95."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    train, val = mnist_iters(mx)
    mod = mx.mod.Module(sym, context=[mx.gpu(0), mx.gpu(0)])
    ticks = []
    mx.random.seed(SEED)
    fc_relu.launches = 0
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, kvstore="device", optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": TRAIN_MOMENTUM},
            initializer=mx.initializer.Xavier(), num_epoch=TRAIN_EPOCHS,
            batch_end_callback=lambda p: ticks.append(
                (p.nbatch, time.perf_counter())))
    wall = time.perf_counter() - t0
    launches = fc_relu.launches
    steps = TRAIN_EPOCHS * -(-TRAIN_SPLIT // TRAIN_BATCH)
    evals = TRAIN_EPOCHS * -(-(TRAIN_IMAGES - TRAIN_SPLIT) // TRAIN_BATCH)
    acc = mod.score(val, "acc")[0][1]
    step_ms = [(t1 - t0_) * 1e3 for (_, t0_), (n1, t1) in
               zip(ticks, ticks[1:]) if n1 > 0]
    med = statistics.median(step_ms)
    ok = acc > 0.95 and launches == 4 * (steps + evals) and \
        mod._kvstore.stats()["batched_pushes"] == steps
    print(f"dp 14b fit: {TRAIN_EPOCHS} epochs on [gpu(0), gpu(0)] "
          f"kvstore='device' in {wall:.2f} s (eval included); step median "
          f"{med:.3f} ms (p10 {np.percentile(step_ms, 10):.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}) = {TRAIN_BATCH / med * 1e3:.0f}"
          f" images/s; K1 launches {launches} = 4 x ({steps} train + "
          f"{evals} eval forwards); validation accuracy {acc:.4f} (> 0.95) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "14b fit: accuracy, K1's launches or the store's reduces")
    return launches, {"step_ms": med, "images_s": TRAIN_BATCH / med * 1e3,
                      "accuracy": acc}


def dist_data(mx):
    """The first DIST_STEPS global batches of 64 of train_mnist's images,
    in order: -> (x, y) numpy."""
    x, y = mx.test_utils.get_mnist_like(TRAIN_IMAGES)
    n = DIST_STEPS * TRAIN_BATCH
    return np.asarray(x[:n], np.float32), np.asarray(y[:n], np.float32)


def dist_rows(rank, workers):
    """The rows of `dist_data` a worker of `workers` fits: its share of
    each global batch of TRAIN_BATCH, in order."""
    per = TRAIN_BATCH // workers
    return np.concatenate([np.arange(j * TRAIN_BATCH + rank * per,
                                     j * TRAIN_BATCH + (rank + 1) * per)
                           for j in range(DIST_STEPS)])


def dist_worker():
    """One 14c worker (started by the port's launcher, on the card unless
    DIST_WORKER_DEVICE says "cpu"): train_mnist's mlp at batch 32 (its
    half of each global batch of 64) through Module.fit with
    kvstore='dist_sync', SGD on the server, from DIST_OUT's initial
    parameters; then the same with 2-bit compression under other names.
    Writes its parameters, K1's launches, step and wire numbers to
    DIST_OUT."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.environ["DIST_OUT"]
    ctx = mx.cpu() if os.environ.get("DIST_WORKER_DEVICE") == "cpu" \
        else mx.gpu(0)
    rank = int(os.environ["DMLC_RANK"])
    per = TRAIN_BATCH // DIST_WORKERS
    x, y = dist_data(mx)
    rows = dist_rows(rank, DIST_WORKERS)
    init = dict(np.load(os.path.join(out_dir, "init.npz")))
    result, stores, updates_before = {}, [], 0
    for lane, prefix, comp in (("plain", "", None), ("2bit", "c_", DP_2BIT)):
        sym = mlp_symbol(mx, prefix)
        mod = mx.mod.Module(sym, context=ctx, compression_params=comp)
        ticks = []
        fc_relu.launches = 0
        t0 = time.perf_counter()
        mod.fit(mx.io.NDArrayIter(x[rows], y[rows], per), num_epoch=1,
                kvstore="dist_sync", optimizer="sgd",
                optimizer_params={"learning_rate": TRAIN_LR,
                                  "momentum": TRAIN_MOMENTUM},
                arg_params={prefix + k: mx.nd.array(v, ctx=mx.cpu())
                            for k, v in init.items()},
                batch_end_callback=lambda p: ticks.append(
                    time.perf_counter()))
        wall = time.perf_counter() - t0
        launches = fc_relu.launches
        kv = mod._kvstore
        check(kv.num_workers == DIST_WORKERS and mod._update_on_kvstore
              and mod._optimizer.rescale_grad == 1.0 / TRAIN_BATCH,
              "14c: not a dist_sync store updating on the server")
        args, _ = mod.get_params()
        np.savez(os.path.join(out_dir, f"{lane}{rank}.npz"),
                 **{k[len(prefix):]: v.asnumpy() for k, v in args.items()})
        # every round of the fit has applied once this worker's last pull
        # returned: the server's counters are the fit's
        server = kv.server_metrics()[0]
        wire = kv.wire_bytes
        names = mod._exec_group.param_names
        grads = mod._exec_group.grad_arrays[0]
        tgt = mod._exec_group.param_arrays[0]
        t1 = time.perf_counter()
        for _ in range(5):
            kv.push(names[0], grads)
        push_ms = (time.perf_counter() - t1) * 1e3 / 5
        t1 = time.perf_counter()
        for _ in range(5):
            kv.pull(names[0], tgt)
        pull_ms = (time.perf_counter() - t1) * 1e3 / 5
        kv._barrier()
        result[lane] = {
            "launches": launches, "steps": len(ticks),
            "steps_s": (len(ticks) - 1) / (ticks[-1] - ticks[0]),
            "wall_s": wall, "wire_bytes": wire,
            "push_ms": push_ms, "pull_ms": pull_ms,
            "server_update_ms": server["update_ms"],
            "server_updates": server["updates"] - updates_before}
        updates_before = server["updates"] + 5
        stores.append(kv)
    # one stop per worker: the server stops once both sent theirs
    stores[0].close(send_stop=False)
    stores[1].close()
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    print(f"dist worker {rank} OK", flush=True)


def dist_phase(mx, sym, card, workdir, device="cuda"):
    """14c: one ParameterServer and two workers (`dist_worker`) started by
    the port's launcher; after 8 steps both workers' parameters equal bit
    for bit and match one process fitting the global batch of 64 on the
    card within DP_TOL; the 2-bit lane's push is 1/16 of fp32's bytes."""
    t0 = time.perf_counter()
    init = dp_init(mx, sym)
    with tempfile.TemporaryDirectory(dir=workdir) as out:
        np.savez(os.path.join(out, "init.npz"), **init)
        # the server's data plane: gradients through the parameter server
        # (the collective plane, the default, is phase 23a's)
        env = dict(os.environ, DIST_OUT=out, MXNET_PS_REQUEST_TIMEOUT="120",
                   MXNET_KVSTORE_COLLECTIVE="0",
                   DIST_WORKER_DEVICE="cpu" if device == "cpu" else "cuda")
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-m", "incubator_mxnet_tpu_torch.dist.launch",
             "-n", str(DIST_WORKERS), sys.executable, "-c",
             "import chip_smoke; chip_smoke.dist_worker()"],
            cwd=here, env=env, capture_output=True, text=True, timeout=300)
        tail = (proc.stdout + proc.stderr)[-3000:]
        check(proc.returncode == 0, f"14c: the launched job failed "
              f"(rc {proc.returncode}):\n{tail}")
        res = [json.load(open(os.path.join(out, f"result{r}.json")))
               for r in range(DIST_WORKERS)]
        params = {lane: [dict(np.load(os.path.join(out, f"{lane}{r}.npz")))
                         for r in range(DIST_WORKERS)]
                  for lane in ("plain", "2bit")}
    launch_s = time.perf_counter() - t0
    x, y = dist_data(mx)
    ctx = mx.gpu(0)
    mod = mx.mod.Module(sym, context=ctx)
    mod.fit(mx.io.NDArrayIter(x, y, TRAIN_BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": TRAIN_LR,
                                               "momentum": TRAIN_MOMENTUM},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in init.items()})
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    same = all(np.array_equal(params["plain"][0][k], params["plain"][1][k])
               and np.array_equal(params["2bit"][0][k], params["2bit"][1][k])
               for k in want)
    pw, pn = held_worst(params["plain"][0], want, DP_TOL)
    plain, comp = res[0]["plain"], res[0]["2bit"]
    ratio = comp["wire_bytes"] / plain["wire_bytes"]
    launches = [r[lane]["launches"] for r in res for lane in r]
    k1_ok = device != "cuda" or all(n == 2 * DIST_STEPS for n in launches)
    ok = same and pw <= 1 and abs(ratio - 1 / 16) < 1e-3 and k1_ok and \
        all(r[lane]["steps"] == DIST_STEPS for r in res for lane in r) and \
        plain["server_updates"] == comp["server_updates"] == 6 * DIST_STEPS
    print(f"dist 14c: {DIST_WORKERS} workers x batch "
          f"{TRAIN_BATCH // DIST_WORKERS}, Module.fit(kvstore='dist_sync') "
          f"{DIST_STEPS} steps through the launcher ({launch_s:.1f} s with "
          f"process starts): workers equal bit for bit {same}; vs one "
          f"process at batch {TRAIN_BATCH} on the card at {pw:.3f} of the "
          f"tolerance (worst {pn}; rtol {DP_TOL[0]:g}, atol "
          f"{DP_TOL[1]:g}*max|array|); {plain['steps_s']:.1f} steps/s "
          f"(2bit {comp['steps_s']:.1f}), push {plain['push_ms']:.3f} ms, "
          f"pull {plain['pull_ms']:.3f} ms (fc1_weight, 100352 floats; "
          f"2bit push {comp['push_ms']:.3f} ms), server update "
          f"{plain['server_update_ms']:.3f} ms over "
          f"{plain['server_updates']} updates; push wire {comp['wire_bytes']}"
          f" bytes 2bit vs {plain['wire_bytes']} fp32 = {ratio:.5f} (1/16 = "
          f"0.0625); K1 launches per worker and lane {launches} "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "14c: the dist_sync workers disagree")
    return {"steps_s": plain["steps_s"], "push_ms": plain["push_ms"],
            "pull_ms": plain["pull_ms"], "wire_ratio": ratio,
            "server_update_ms": plain["server_update_ms"],
            "launches": sum(launches)}


def wd_losses(mx, losses):
    """A batch-end callback appending each batch's mean -log p[label]."""
    def cb(param):
        mod = param.locals["self"]
        batch = param.locals["data_batch"]
        losses.append(cross_entropy(mod.get_outputs()[0], batch.label[0]))
    return cb


def wd_state(run):
    table = run["table"]
    st = table.stats()
    return {"tower": {k: v.asnumpy() for k, v in
                      run["mod"].get_params()[0].items()},
            "table": table.checkpoint_rows(),
            "counters": {"pushes": run["adapter"].pushes,
                         "shards": [(s["rows_pushed"], s["rows_pulled"])
                                    for s in st["shards"].values()],
                         "cache": {k: st["cache"][k] for k in
                                   ("hits", "misses", "evictions", "rows")}}}


def wd_profile(mx, run, card, tries=3):
    """One profiled batch of the trained example: the adapter's lookup,
    the module's step, the row-sparse push; -> (host ms, busy share)."""
    from torch.profiler import ProfilerActivity, profile
    adapter, mod = run["adapter"], run["mod"]
    metric = mx.metric.create("acc")
    adapter.reset()
    batch = adapter.next()
    mod.fit_step(batch, metric)
    adapter.push_from(mod)
    for _ in range(tries):
        batch = adapter.next()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mod.fit_step(batch, metric)
            adapter.push_from(mod)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
    check(spans, "14d: the profiler saw no device activity in a batch")
    busy, edge = 0.0, -math.inf
    for start, end in spans:
        busy += max(0.0, end - max(start, edge))
        edge = max(edge, end)
    print(f"wide_deep 14d profile: one batch (step + push) "
          f"{wall_us / 1e3:.3f} ms on the host clock, {len(spans)} kernels, "
          f"device busy {busy / 1e3:.3f} ms = {busy / wall_us:.3f} of the "
          f"window [{card}]")
    return wall_us / 1e3, busy / wall_us


def wd_phase(mx, card):
    """14d: examples/recommender/wide_deep.py at its defaults on the card
    (TPU_PALLAS: K1 in the tower's deep1) against the port on the CPU
    from the same seeds: every epoch-1 batch's loss, the final tower and
    the whole table, and the tier's counters."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    cfg = WD_CFG
    sym = wd_tower(mx, WD_SLOTS * cfg["dim"], 4)
    shapes, _, _ = sym.infer_shape(emb=(cfg["batch"], WD_SLOTS * cfg["dim"]),
                                   dense=(cfg["batch"], 4))
    rng = np.random.RandomState(WD_PARAMS_SEED)
    init = {n: rng.uniform(-0.1, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("emb", "dense", "softmax_label")}
    batches = cfg["samples"] // cfg["batch"]
    closs = []
    t0 = time.perf_counter()
    run = wide_deep(mx, cfg, mx.cpu(), arg_params=init,
                    batch_end=wd_losses(mx, closs))
    cpu_s = time.perf_counter() - t0
    try:
        ref = wd_state(run)
    finally:
        wide_deep_close(run)
    gloss, ticks = [], []
    fc_relu.launches = 0
    t0 = time.perf_counter()

    def tick(param):
        ticks.append(time.perf_counter())
    cb = wd_losses(mx, gloss)
    run = wide_deep(mx, cfg, mx.gpu(0), arg_params=init,
                    batch_end=lambda p: (cb(p), tick(p)))
    try:
        wall = time.perf_counter() - t0
        launches = fc_relu.launches
        got = wd_state(run)
        srv = [s.stats() for s in run["servers"]]
        table = run["table"]
        ids = np.asarray(run["adapter"]._last_ids)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(20):
            table.lookup(ids)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t1) * 1e3 / 20
        dev_ms = device_ms(lambda: table.lookup(ids), reps=10)
        grads = np.ones((ids.size, cfg["dim"]), np.float32) * 1e-3
        t1 = time.perf_counter()
        for _ in range(10):
            table.push_grad(ids.ravel(), grads)
        push_ms = (time.perf_counter() - t1) * 1e3 / 10
        prof_ms, busy = wd_profile(mx, run, card)
    finally:
        wide_deep_close(run)
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gloss[:batches],
                                                        closs[:batches]))
    tw, tn = held_worst(got["tower"], ref["tower"], WD_TOL)
    table_w, _ = held_worst({"table": got["table"]}, {"table": ref["table"]},
                            WD_TOL)
    steps = cfg["epochs"] * batches
    ok = loss_err <= WD_TOL[0] and tw <= 1 and table_w <= 1 and \
        got["counters"] == ref["counters"] and launches == steps and \
        len(gloss) == steps
    cache = got["counters"]["cache"]
    hit_rate = cache["hits"] / max(cache["hits"] + cache["misses"], 1)
    upd_ms = sum(s["update_s"] for s in srv) * 1e3 / max(
        sum(s["updates"] for s in srv), 1)
    step_ms = statistics.median(np.diff(ticks) * 1e3)
    print(f"wide_deep 14d: {cfg['rows']}x{cfg['dim']} table on "
          f"{cfg['shards']} shard servers, batch {cfg['batch']}, "
          f"{cfg['samples']} samples x {cfg['epochs']} epochs on the card vs "
          f"the CPU: epoch-1 loss max rel err {loss_err:.2e} (rtol "
          f"{WD_TOL[0]:g}); tower at {tw:.3f} (worst {tn}), table at "
          f"{table_w:.3f} of the tolerance (rtol {WD_TOL[0]:g}, atol "
          f"{WD_TOL[1]:g}*max|array|); counters equal "
          f"{got['counters'] == ref['counters']} ({got['counters']}); "
          f"K1 launches {launches} (1 a forward, {steps} forwards) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    print(f"wide_deep 14d: {cfg['samples'] * cfg['epochs'] / wall:.1f} "
          f"samples/s ({wall:.2f} s with set-up; the same run with the "
          f"tower and the cache on this host's CPU "
          f"{cfg['samples'] * cfg['epochs'] / cpu_s:.1f}), step median "
          f"{step_ms:.3f} "
          f"ms; cache hit rate {hit_rate:.4f}; lookup of a batch "
          f"({ids.size} ids, all hot) {host_ms:.3f} ms host, {dev_ms:.4f} ms"
          f" device; push_grad round trip {push_ms:.3f} ms; the servers' "
          f"lazy update {upd_ms:.3f} ms a push (the server threads' share "
          f"of a step {upd_ms / step_ms:.3f}); profiled batch "
          f"{prof_ms:.3f} ms, busy {busy:.3f} [{card}]")
    check(ok, "14d: wide_deep on the card disagrees with the CPU")
    return launches, {"samples_s": cfg["samples"] * cfg["epochs"] / wall,
                      "hit_rate": hit_rate, "lookup_host_ms": host_ms,
                      "lookup_device_ms": dev_ms, "push_ms": push_ms,
                      "busy": busy}


def kv_phase(card, workdir):
    """Phase 14; returns K1's launches on the 14b and 14d paths and the
    numbers of the summary."""
    import incubator_mxnet_tpu_torch as mx
    old = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    out = {}
    try:
        t0 = time.perf_counter()
        out["kv_worst"] = kv_card(mx, card)
        sym = mlp_symbol(mx)
        out["dp_launches"] = dp_free(mx, sym, card)
        out["dp_2bit"] = dp_compressed(mx, sym, card)
        fit_launches, out["dp_fit"] = dp_fit(mx, sym, card)
        out["dp_launches"] += fit_launches
        print(f"phase 14b: {time.perf_counter() - t0:.1f} s (with 14a)")
        t0 = time.perf_counter()
        out["dist"] = dist_phase(mx, sym, card, workdir)
        print(f"phase 14c: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        out["wd_launches"], out["wd"] = wd_phase(mx, card)
        print(f"phase 14d: {time.perf_counter() - t0:.1f} s")
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        if old is not None:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    return out


# ---------------------------------------------------------------------------
# Phase 15: the registry's tail and the rest of the training API
# ---------------------------------------------------------------------------

# 15a: tolerances by family (rtol, atol * max|ref|); "exact" is bit for bit
OPS15_TOL = {"exact": None, "arith": (1e-5, 1e-6), "prod": (1e-4, 1e-5)}
OPS15_NEAR = 1e-4      # 15a/b: a sign or threshold within this * max|x|
HIST15_NEAR = 1e-6     # 15a: a value within this * max|edge| of an edge
FTRL15_L1 = 0.01       # Ftrl's default lamda1, its threshold
REFUSE15 = ("rmsprop", "adagrad", "adadelta", "adam", "adamax", "nadam",
            "ftml", "ftrl", "sgld")   # no momentum argument
RANDOM15_DRAWS = 10 ** 6
# 15b: lstm_bucketing.py's optimizer params with --optimizer <name>
# (momentum only where the optimizer takes it: --mom 0.9)
LSTM15_OPT = {"learning_rate": 0.01, "wd": 1e-5, "rescale_grad": 1.0 / 32}
LSTM15_LANES = (                # (label, optimizer, its params, flag)
    ("nag", "nag", {"momentum": 0.9}, True),
    ("signum", "signum", {"momentum": 0.9}, True),
    ("dcasgd", "dcasgd", {"momentum": 0.9}, True),
    ("lbsgd", "lbsgd", {"momentum": 0.9}, True),
    ("rmsprop", "rmsprop", {}, False),
    ("rmsprop centered", "rmsprop", {"centered": True}, False),
    ("adagrad", "adagrad", {}, False),
    ("adadelta", "adadelta", {}, False),
    ("adamax", "adamax", {}, False),
    ("nadam", "nadam", {}, False),
    ("ftml", "ftml", {}, False),
    ("ftrl", "ftrl", {}, False),
    ("sgld", "sgld", {}, False),
)
# 15b: the dtype each lane is held in (11a's gate): fp32 where it holds
# there; float64 (the default) for the adaptive ones that scale a
# gradient near 0 by lr / (its running size + eps) and SGLD; RMSProp
# centered with SoftmaxOutput's softmax in float64 too (`opt15_witness`)
OPT15_GATE = {"nag": "fp32", "signum": "fp32", "dcasgd": "fp32",
              "lbsgd": "fp32", "adadelta": "fp32", "ftrl": "fp32",
              "rmsprop centered": "float64 softmax"}
# 15b: bucket-60 steps timed after parity, on the fp32 card run of each
# lane held in fp32 (the lanes held in float64 have no fp32 run: a cut,
# with their printed fp32 reading, of 15b's 142 s)
LSTM15_TIMED = 3
# 15b: the parity steps, a batch of each listed bucket in turn: a switch
# between buckets on the shared parameters, 2 updates of every
# optimizer's states, the second from the first's (a cut of 11a's 6
# steps, 60/20/40/20/60/10, to take back chip time: 15b took 99.7 s with
# 6 steps, 53.3 s with 3 (60/20/60) on another card; the timed lanes
# take their bucket-60 batch from these)
LSTM15_PARITY_KEYS = (60, 20)
# 15c: train_mnist's mlp as a SequentialModule
SEQ15_STEPS = 8
SEQ15_TOL = (1e-5, 1e-6)        # 15c: the split against one Module
MON15_TOL = (1e-4, 1e-5)        # 15c: the monitor's statistics, card vs CPU
SEQ15_LR_MULT = 0.5
CARD15 = "cuda"                 # the card's torch device (a CPU rehearsal
                                # points it at "cpu")


def r15(shape, seed=0, dtype=np.float32, scale=1.0):
    return torch.from_numpy((np.random.RandomState(seed).normal(
        0, scale, shape)).astype(dtype))


def ties15(shape, seed=0):
    """Values on a grid of 0.5, so many tie."""
    return torch.round(r15(shape, seed) * 2) / 2


def ints15(values):
    return torch.as_tensor(np.asarray(values, np.float32))


def spd15(n, batch, seed=0):
    a = r15((batch, n, n), seed, np.float64)
    return a @ a.transpose(1, 2) + n * torch.eye(n, dtype=torch.float64)


def lower15(n, batch, seed=0):
    return torch.linalg.cholesky(spd15(n, batch, seed))


def ops15_cases():
    """Phase 15a's cases: (op, params, CPU inputs, differentiated inputs,
    family), at the shapes of the ops' users (DCGAN's generator,
    AlexNet's conv1 output, SSD's conv4_3, lstm_ocr's CTC; else the sizes
    of tests/test_operator.py scaled to ~10^6 elements)."""
    rng = np.random.RandomState(SEED)
    x3 = r15((100, 100, 100))
    seq = r15((50, 128, 160))
    lens = ints15(rng.randint(1, 51, 128))
    flat = rng.permutation(100 * 100)[:10000]
    qkv = r15((128, 32, 3 * 8 * 64), scale=0.3)
    cases = [
        ("slice", {"begin": (10, None, 0), "end": (90, None, 100),
                   "step": (1, None, 2)}, [x3], (0,), "exact"),
        ("slice", {"begin": (90,), "end": (10,), "step": (-2,)}, [x3], (0,),
         "exact"),
        ("slice_like", {"axes": (0, 1)}, [x3, r15((50, 60, 100))], (0,),
         "exact"),
        ("reverse", {"axis": 1}, [x3], (0,), "exact"),
        ("tile", {"reps": (2, 2)}, [r15((250, 400))], (0,), "exact"),
        ("repeat", {"repeats": 2, "axis": 1}, [r15((500, 1000))], (0,),
         "exact"),
        ("Pad", {"mode": "constant", "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                 "constant_value": 0.5}, [r15((16, 64, 32, 32))], (0,),
         "exact"),
        ("Pad", {"mode": "edge", "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)},
         [r15((16, 64, 32, 32))], (0,), "exact"),
        ("Pad", {"mode": "reflect", "pad_width": (0, 0, 0, 0, 3, 1, 1, 2)},
         [r15((16, 64, 32, 32))], (0,), "exact"),
        ("take", {}, [r15((1000, 1000)),
                      ints15(rng.randint(-50, 1050, (200, 50)))], (0,),
         "exact"),
        ("take", {"mode": "wrap", "axis": 1},
         [r15((1000, 1000)), ints15(rng.randint(-2000, 2000, 1000))], (0,),
         "exact"),
        ("batch_take", {}, [r15((1000, 1000)),
                            ints15(rng.randint(0, 1100, 1000))], (0,),
         "exact"),
        ("one_hot", {"depth": 100, "on_value": 2.0, "off_value": -1.0},
         [ints15(rng.randint(-5, 105, 10000))], (), "exact"),
        ("gather_nd", {}, [x3, ints15(rng.randint(0, 100, (2, 10000)))],
         (0,), "exact"),
        ("scatter_nd", {"shape": (100, 100, 100)},
         [r15((10000, 100)), ints15(np.stack([flat // 100, flat % 100]))],
         (0,), "exact"),
        ("topk", {"k": 10, "ret_typ": "both"}, [ties15((1000, 1000))], (0,),
         "exact"),
        ("topk", {"k": 5, "ret_typ": "mask", "axis": 0},
         [ties15((1000, 1000))], (), "exact"),
        ("topk", {"k": 7, "ret_typ": "value", "is_ascend": True},
         [ties15((1000, 1000))], (0,), "exact"),
        ("sort", {}, [ties15((1000, 1000))], (0,), "exact"),
        ("sort", {"axis": 0, "is_ascend": False}, [ties15((1000, 1000))],
         (0,), "exact"),
        ("argsort", {}, [ties15((1000, 1000))], (), "exact"),
        ("argsort", {"axis": 0, "is_ascend": False},
         [ties15((1000, 1000))], (), "exact"),
        ("shape_array", {}, [x3], (), "exact"),
        ("size_array", {}, [x3], (), "exact"),
        ("diag", {"k": 1}, [r15((1000, 1000))], (0,), "exact"),
        ("diag", {"k": -1}, [r15((1000,))], (0,), "exact"),
        ("depth_to_space", {"block_size": 2}, [r15((16, 256, 16, 16))],
         (0,), "exact"),
        ("space_to_depth", {"block_size": 2}, [r15((16, 64, 32, 32))],
         (0,), "exact"),
        ("SequenceLast", {"use_sequence_length": True}, [seq, lens], (0,),
         "exact"),
        ("SequenceMask", {"use_sequence_length": True, "value": -1.0},
         [seq, lens], (0,), "exact"),
        ("SequenceMask", {"use_sequence_length": True, "axis": 1},
         [seq.transpose(0, 1).contiguous(), lens],
         (0,), "exact"),
        ("SequenceReverse", {"use_sequence_length": True}, [seq, lens],
         (0,), "exact"),
        ("InstanceNorm", {}, [r15((8, 64, 128, 128)), r15((64,), 1),
                              r15((64,), 2)], (0, 1, 2), "arith"),
        ("L2Normalization", {"mode": "channel"}, [r15((16, 512, 38, 38))],
         (0,), "arith"),
        ("L2Normalization", {}, [r15((64, 128, 128))], (0,), "arith"),
        ("L2Normalization", {"mode": "spatial"}, [r15((16, 64, 32, 32))],
         (0,), "arith"),
        ("LRN", {"nsize": 5}, [r15((128, 96, 55, 55))], (0,), "arith"),
        ("SoftmaxActivation", {}, [r15((1000, 1000))], (0,), "arith"),
        ("SoftmaxActivation", {"mode": "channel"}, [r15((16, 64, 32, 32))],
         (0,), "arith"),
        ("UpSampling", {"scale": 2, "sample_type": "nearest"},
         [r15((16, 256, 38, 38))], (0,), "exact"),
        ("UpSampling", {"scale": 2, "sample_type": "bilinear"},
         [r15((16, 256, 38, 38))], (0,), "prod"),
        ("_arange", {"start": 1.0, "stop": 1e6, "step": 1.0, "repeat": 1},
         [], (), "exact"),
        ("_eye", {"N": 1000, "M": 1000, "k": 1}, [], (), "exact"),
        ("_linspace", {"start": -3.0, "stop": 7.0, "num": 10 ** 6}, [], (),
         "exact"),
        ("_contrib_quadratic", {"a": 0.5, "b": -1.0, "c": 2.0},
         [r15((1000, 1000))], (0,), "arith"),
        ("_contrib_arange_like", {"start": 1.0, "step": 0.5, "repeat": 2},
         [r15((1000, 1000))], (), "arith"),
        ("_contrib_AdaptiveAvgPooling2D", {"output_size": (8, 8)},
         [r15((16, 64, 64, 64))], (0,), "arith"),
        ("_contrib_AdaptiveAvgPooling2D", {"output_size": (7, 7)},
         [r15((16, 64, 64, 64))], (0,), "prod"),
        ("_contrib_BilinearResize2D", {"height": 96, "width": 80},
         [r15((16, 64, 64, 64))], (0,), "prod"),
        ("_contrib_div_sqrt_dim", {}, [r15((1000, 1024))], (0,), "arith"),
        ("_contrib_interleaved_matmul_selfatt_qk", {"heads": 8}, [qkv],
         (0,), "prod"),
        ("_contrib_interleaved_matmul_selfatt_valatt", {"heads": 8},
         [qkv, torch.softmax(r15((256, 128, 128), 1), -1)], (0, 1), "prod"),
        ("_contrib_boolean_mask_supported", {}, [], (), "exact"),
        ("_contrib_index_copy", {},
         [r15((1000, 1000)), ints15(rng.permutation(1000)[:100]),
          r15((100, 1000), 1)], (0, 2), "exact"),
        ("_contrib_index_array", {}, [r15((1000, 500))], (), "exact"),
        ("_contrib_getnnz", {"axis": 0},
         [torch.relu(r15((1000, 1000)))], (), "exact"),
        ("_contrib_fft", {}, [r15((1000, 1024))], (0,), "prod"),
        ("_contrib_ifft", {}, [r15((500, 2048))], (0,), "prod"),
        ("_contrib_count_sketch", {"out_dim": 256},
         [r15((1000, 1000)), ints15(rng.randint(0, 256, 1000)),
          ints15(rng.choice([-1.0, 1.0], 1000))], (0,), "arith"),
        ("khatri_rao", {"num_args": 3}, [r15((100, 64)), r15((50, 64), 1),
                                         r15((20, 64), 2)], (0, 1, 2),
         "prod"),
        ("_ravel_multi_index", {"shape": (100, 100, 100)},
         [ints15(rng.randint(0, 100, (3, 10 ** 6)))], (), "exact"),
        ("_unravel_index", {"shape": (100, 100, 100)},
         [ints15(rng.randint(0, 10 ** 6, 10 ** 6))], (), "exact"),
        ("_square_sum", {"axis": 1, "keepdims": True}, [r15((1000, 1000))],
         (0,), "arith"),
        ("cast_storage", {"stype": "csr"}, [r15((1000, 1000))], (0,),
         "exact"),
        ("sparse_retain", {}, [r15((1000, 1000)),
                               ints15(rng.permutation(1000)[:300])], (0,),
         "exact"),
        ("_contrib_SyncBatchNorm", {"fix_gamma": False},
         [r15((32, 64, 32, 32)), r15((64,), 1), r15((64,), 2),
          torch.zeros(64), torch.ones(64)], (0, 1, 2), "arith"),
    ]
    # train_dcgan's generator: 4x4, stride 2, pad 1, batch 64, 512 -> 256
    # -> 128 -> 64 -> 3, up to 64 x 64 (Radford et al. 2016)
    for k, (cin, cout, hw) in enumerate(((512, 256, 4), (256, 128, 8),
                                         (128, 64, 16), (64, 3, 32))):
        cases.append(("Deconvolution", {"kernel": (4, 4), "stride": (2, 2),
                                        "pad": (1, 1), "num_filter": cout,
                                        "no_bias": True},
                      [r15((64, cin, hw, hw), k),
                       r15((cin, cout, 4, 4), k + 10, scale=0.02)],
                      (0, 1), "prod"))
    cases.append(("Deconvolution", {"kernel": (3, 3), "stride": (2, 2),
                                    "pad": (1, 1), "adj": (1, 1),
                                    "num_filter": 64, "num_group": 2},
                  [r15((16, 64, 32, 32)), r15((64, 32, 3, 3), 1, scale=0.05),
                   r15((64,), 2)], (0, 1, 2), "prod"))
    lin = [
        ("linalg_gemm", {"transpose_a": True, "alpha": 0.5, "beta": 2.0},
         [r15((16, 64, 64), 0, np.float64), r15((16, 64, 64), 1, np.float64),
          r15((16, 64, 64), 2, np.float64)], (0, 1, 2)),
        ("linalg_gemm2", {"transpose_b": True},
         [r15((16, 64, 64), 0, np.float64),
          r15((16, 64, 64), 1, np.float64)], (0, 1)),
        ("linalg_potrf", {}, [spd15(64, 16)], (0,)),
        ("linalg_potri", {}, [lower15(64, 16)], (0,)),
        ("linalg_trsm", {"alpha": 1.5}, [lower15(64, 16),
                                         r15((16, 64, 64), 1, np.float64)],
         (0, 1)),
        ("linalg_trsm", {"transpose": True, "rightside": True},
         [lower15(64, 16), r15((16, 64, 64), 1, np.float64)], (0, 1)),
        ("linalg_trmm", {"lower": False},
         [lower15(64, 16).transpose(1, 2).contiguous(),
          r15((16, 64, 64), 1, np.float64)], (0, 1)),
        ("linalg_syrk", {"alpha": 0.5}, [r15((16, 64, 64), 0, np.float64)],
         (0,)),
        ("linalg_sumlogdiag", {}, [lower15(64, 16)], (0,)),
        ("linalg_extractdiag", {"offset": 1},
         [r15((16, 64, 64), 0, np.float64)], (0,)),
        ("linalg_makediag", {}, [r15((16, 64), 0, np.float64)], (0,)),
        ("linalg_extracttrian", {}, [r15((16, 64, 64), 0, np.float64)],
         (0,)),
        ("linalg_inverse", {}, [spd15(64, 16)], (0,)),
        ("linalg_det", {}, [spd15(8, 16)], (0,)),
        ("linalg_slogdet", {}, [r15((16, 64, 64), 0, np.float64)], (0,)),
    ]
    cases += [(op, p, x, g, "prod") for op, p, x, g in lin]
    return cases


def pair15(name, params, inputs, grad_idx=(), seed=SEED):
    """`name` on the CPU and on the card on the same inputs, and the
    gradients of inputs `grad_idx` under one seeded cotangent of the
    first output (in its dtype).  Returns [(outs, grads) CPU, (outs,
    grads) card] as CPU tensors."""
    from incubator_mxnet_tpu_torch.ops import registry
    op = registry.get(name)
    p = op.canonicalize_params(params)
    p.pop("ctx", None)
    if op.mode_dependent:
        p["_train"] = True
    res = []
    for dev in ("cpu", CARD15):
        xs = [t.to(dev).clone() for t in inputs]
        for i in grad_idx:
            xs[i].requires_grad_()
        with torch.set_grad_enabled(bool(grad_idx)):
            out = op.fn(p, *xs) if op.nin else op.fn(p, device=dev)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        grads = []
        if grad_idx:
            ct = torch.from_numpy(np.random.RandomState(seed + 7).normal(
                0, 1, tuple(outs[0].shape))).to(dev, outs[0].dtype)
            grads = torch.autograd.grad(outs[0], [xs[i] for i in grad_idx],
                                        ct, allow_unused=True)
            grads = [torch.zeros_like(xs[i]) if g is None else g
                     for i, g in zip(grad_idx, grads)]
        res.append(([o.detach().cpu() for o in outs],
                    [g.detach().cpu() for g in grads]))
    return res


def ratio15(got, ref, tol, what, excuse=None):
    """max |got - ref| / (rtol |ref| + atol max|ref|) outside `excuse`
    (0 for "exact" when bit for bit, else inf), checked <= 1."""
    got, ref = got.double(), ref.double()
    check(got.shape == ref.shape, f"{what}: shape {tuple(got.shape)} vs "
          f"{tuple(ref.shape)}")
    if tol is None:
        diff = got != ref
        if excuse is not None:
            diff &= ~excuse
        r = 0.0 if not bool(diff.any()) else math.inf
    else:
        bound = (tol[0] * ref.abs() + tol[1] * ref.abs().max()).clamp_min(
            1e-300)
        err = (got - ref).abs() / bound
        if excuse is not None:
            err = torch.where(excuse, torch.zeros_like(err), err)
        r = float(err.max()) if err.numel() else 0.0
    check(r <= 1.0, f"{what}: {r:.3g} of the tolerance")
    return r


def ops15_registry(mx, card):
    """15a: every op this PR registered, on the card against the port on
    the CPU; returns (names covered, worst share of the tolerance)."""
    from incubator_mxnet_tpu_torch.ops import registry
    done, worst, rows = set(), (0.0, ""), {}
    t0 = time.perf_counter()
    for op, params, inputs, gidx, fam in ops15_cases():
        (c_out, c_g), (g_out, g_g) = pair15(op, params, inputs, gidx)
        what = f"15a {op} {params}"
        r = max([ratio15(g, c, OPS15_TOL[fam], what + f" out {k}")
                 for k, (g, c) in enumerate(zip(g_out, c_out))] +
                [ratio15(g, c, OPS15_TOL["arith" if fam == "exact" else
                                         fam], what + f" grad {i}")
                 for i, g, c in zip(gidx, g_g, c_g)])
        worst = max(worst, (r, op))
        done.add(registry.get(op))
        rows.setdefault(fam, []).append(r)
    # the update ops, one step on (1000, 1000): sign and threshold near
    # ties (within OPS15_NEAR * max of the CPU's value) counted, excused
    upd, ties = ops15_updates(mx)
    worst = max(worst, upd)
    done |= {registry.get(n) for n in OPS15_UPDATES}
    done |= {registry.get(n) for n in ops15_ctc(mx, card)}
    done |= {registry.get(n) for n in ops15_histogram(mx, card)}
    done |= {registry.get(n) for n in ops15_random(mx, card)}
    done |= {registry.get(n) for n in ops15_decompositions(mx, card)}
    names = sorted(n for n in registry.list_ops()
                   if registry.get(n) in done)
    ported = set(SLICE13_OPS)
    missing = sorted(ported - set(names))
    check(not missing, f"15a: ops not run on the card: {missing}")
    print(f"ops15: {len(ported)} op names of this slice on the card against "
          f"the CPU ({len(done)} distinct ops): worst "
          f"{worst[0]:.3f} of the tolerance ({worst[1]}); by family "
          + ", ".join(f"{fam} {len(v)} cases worst {max(v):.3f}"
                      for fam, v in rows.items())
          + f"; {ties} update-op near ties excused; "
          f"{time.perf_counter() - t0:.1f} s [{card}]")
    return len(ported), worst


# the names this slice registered (the JAX registry's less the 9
# quantization ops, less what the port had before)
SLICE13_OPS = (
    "CTCLoss", "Deconvolution", "InstanceNorm", "L2Normalization", "LRN",
    "Pad", "SequenceLast", "SequenceMask", "SequenceReverse",
    "SoftmaxActivation", "SyncBatchNorm", "UpSampling", "_arange",
    "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
    "_contrib_CTCLoss", "_contrib_SyncBatchNorm", "_contrib_arange_like",
    "_contrib_boolean_mask_supported", "_contrib_count_sketch",
    "_contrib_ctc_loss", "_contrib_div_sqrt_dim", "_contrib_fft",
    "_contrib_getnnz", "_contrib_ifft", "_contrib_index_array",
    "_contrib_index_copy", "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt", "_contrib_quadratic",
    "_eye", "_histogram", "_linspace", "_random_exponential",
    "_random_gamma", "_random_generalized_negative_binomial",
    "_random_negative_binomial", "_random_normal", "_random_poisson",
    "_random_randint", "_random_uniform", "_ravel_multi_index",
    "_sample_gamma", "_sample_multinomial", "_sample_normal",
    "_sample_uniform", "_shuffle", "_square_sum", "_unravel_index",
    "adam_update", "argsort", "batch_take", "cast_storage", "crop",
    "ctc_loss", "depth_to_space", "diag", "fft", "flip", "ftrl_update",
    "gamma_sample", "gather_nd", "histogram", "ifft", "khatri_rao",
    "linalg_det", "linalg_extractdiag", "linalg_extracttrian",
    "linalg_gelqf", "linalg_gemm", "linalg_gemm2", "linalg_inverse",
    "linalg_makediag", "linalg_potrf", "linalg_potri", "linalg_slogdet",
    "linalg_sumlogdiag", "linalg_syevd", "linalg_syrk", "linalg_trmm",
    "linalg_trsm", "mp_sgd_mom_update", "mp_sgd_update", "normal",
    "one_hot", "pad", "quadratic", "ravel_multi_index", "repeat", "reverse",
    "rmsprop_update", "rmspropalex_update", "scatter_nd", "sgd_mom_update",
    "sgd_update", "shape_array", "shuffle", "signsgd_update",
    "signum_update", "size_array", "slice", "slice_like", "sort",
    "space_to_depth", "sparse_retain", "take", "tile", "topk", "uniform",
    "unravel_index")

OPS15_UPDATES = {   # op: (states, params)
    "sgd_update": ((), {}),
    "sgd_mom_update": (("mom",), {"momentum": 0.9}),
    "mp_sgd_update": (("w32",), {}),
    "mp_sgd_mom_update": (("mom", "w32"), {"momentum": 0.9}),
    "adam_update": (("mean", "var"), {"beta1": 0.9, "beta2": 0.999}),
    "rmsprop_update": (("n",), {"gamma1": 0.9}),
    "rmspropalex_update": (("n", "g_avg", "delta"), {"gamma1": 0.9,
                                                      "gamma2": 0.9}),
    "ftrl_update": (("z", "n"), {"lamda1": 0.01}),
    "signsgd_update": ((), {}),
    "signum_update": (("mom",), {"momentum": 0.9, "wd_lh": 0.01}),
}


def ops15_updates(mx):
    """The 10 update ops through their nd frontends (out=weight, states
    in place), card against CPU on (1000, 1000): weight and states at
    the arithmetic tolerance; an element whose sign (signsgd: of the
    rescaled gradient; signum: of the new momentum) or Ftrl threshold
    |z| - lamda1 lies within OPS15_NEAR * max|.| of the flip is counted
    and excused.  Returns ((worst, op), the excused elements that were
    off)."""
    worst, ties = (0.0, ""), 0
    kw = dict(lr=0.05, wd=1e-3, rescale_grad=0.5, clip_gradient=2.0)
    for op, (states, extra) in OPS15_UPDATES.items():
        rng = np.random.RandomState(SEED + len(op))
        shape = (1000, 1000)
        low = op.startswith("mp_")
        vals = {"w": rng.normal(0, 1, shape), "g": rng.normal(0, 3, shape)}
        for s in states:
            vals[s] = np.abs(rng.normal(0, 0.5, shape)) + 0.1 \
                if s in ("n", "var") else rng.normal(0, 0.3, shape)
        if "g_avg" in vals:
            vals["n"] = vals["n"] + vals["g_avg"] ** 2
        res = []
        for ctx in (mx.cpu(), mx.gpu(0)):
            arrs = {k: mx.nd.array(v, ctx=ctx, dtype="float16" if low and
                                   k in ("w", "g") else "float32")
                    for k, v in vals.items()}
            if "w32" in arrs:
                arrs["w32"] = arrs["w"].astype("float32")
            getattr(mx.nd, op)(*(arrs[a] for a in ("w", "g") + states),
                               out=arrs["w"], **kw, **extra)
            res.append({k: arrs[k].data.cpu() for k in ("w",) + states})
        cpu, card = res
        near = None
        if op == "signsgd_update":
            g = torch.from_numpy(vals["g"]).float() * kw["rescale_grad"]
            near = g.abs() <= OPS15_NEAR * g.abs().max()
        elif op == "signum_update":
            near = cpu["mom"].abs() <= OPS15_NEAR * cpu["mom"].abs().max()
        elif op == "ftrl_update":
            z = cpu["z"].abs()
            near = (z - extra["lamda1"]).abs() <= OPS15_NEAR * z.max()
        if near is not None:
            err = (card["w"].double() - cpu["w"].double()).abs()
            ties += int((near & (err > OPS15_TOL["arith"][0] *
                                 cpu["w"].double().abs() +
                                 OPS15_TOL["arith"][1] *
                                 cpu["w"].double().abs().max())).sum())
        for k in ("w",) + states:
            worst = max(worst, (ratio15(card[k], cpu[k], OPS15_TOL["arith"],
                                        f"15a {op} {k}",
                                        near if k == "w" else None), op))
    return worst, ties


def ops15_ctc(mx, card):
    """ctc_loss at upstream's lstm_ocr shapes (T 80, batch 128, 11
    classes, 4 labels), one row unable to fit: the card route (the
    library's F.ctc_loss, the plain loop for that row) against the port
    on the CPU, and against `ctc_plain` on the card; loss and gradient
    at the product tolerance."""
    from incubator_mxnet_tpu_torch.ops import ctc
    rng = np.random.RandomState(SEED)
    data = r15((80, 128, 11))
    label = rng.randint(1, 11, (128, 4)).astype(np.float32)
    label[5] = [3, 3, 3, 3]
    lens = np.full(128, 80, np.float32)
    lens[5] = 5                       # 4 repeated labels need 7 steps
    inputs = [data, torch.from_numpy(label), torch.from_numpy(lens)]
    before = dict(ctc.ctc_routes)
    (c_out, c_g), (g_out, g_g) = pair15(
        "ctc_loss", {"use_data_lengths": True}, inputs, (0,))
    lib = ctc.ctc_routes["library"] - before["library"]
    plain = ctc.ctc_routes["plain"] - before["plain"] - 128
    check(lib == 127 and plain == 1, f"15a ctc: routes library {lib}, "
          f"plain {plain} rows on the card (want 127, 1)")
    fits = torch.ones(128, dtype=torch.bool)
    fits[5] = False       # its ~1e30 loss would set every row's atol
    r_loss = max(ratio15(g_out[0][fits], c_out[0][fits], OPS15_TOL["prod"],
                         "15a ctc loss"),
                 ratio15(g_out[0][~fits], c_out[0][~fits], (1e-6, 0.0),
                         "15a ctc loss of the row that cannot fit"))
    r_grad = ratio15(g_g[0], c_g[0], OPS15_TOL["prod"], "15a ctc grad")
    check(bool(torch.isfinite(g_out[0]).all()), "15a ctc: loss not finite")
    dev = torch.device(CARD15)
    logp = torch.log_softmax(data.to(dev), -1)
    lab = torch.from_numpy(label).long().to(dev)
    in_len = torch.from_numpy(lens).long().to(dev)
    lab_len = (lab > 0).sum(1)
    t0 = time.perf_counter()
    loop = ctc.ctc_plain(logp, lab, in_len, lab_len)
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    r2 = max(ratio15(g_out[0][fits], loop.cpu()[fits], OPS15_TOL["prod"],
                     "15a ctc route vs loop"),
             ratio15(g_out[0][~fits], loop.cpu()[~fits], (0.0, 0.0),
                     "15a ctc route vs loop, the row that cannot fit"))
    print(f"ops15 ctc: (80, 128, 11), 4 labels: the card route (F.ctc_loss "
          f"127 rows, the plain loop the row that cannot fit) vs the CPU: "
          f"loss {r_loss:.3f}, gradient {r_grad:.3f}; loss vs the plain loop "
          f"on the card {r2:.3f} of rtol 1e-4 + 1e-5*max; the loop alone "
          f"{loop_ms:.1f} ms [{card}]")
    return ("ctc_loss",)


def ops15_histogram(mx, card):
    """10^6 values in 100 bins, and in given edges: counts equal but
    for values within OPS15_NEAR of an edge (counted), edges at the
    arithmetic tolerance."""
    x = r15((10 ** 6,))
    ties, moves = 0, 0
    for params, inputs in (({"bin_cnt": 100, "range": (-3.0, 3.0)}, [x]),
                           ({"num_args": 2},
                            [x, torch.linspace(-4, 4, 41)])):
        (c_out, _), (g_out, _) = pair15("_histogram", params, inputs)
        edges = c_out[1].double()
        xd = x.double()
        at = torch.searchsorted(edges, xd).clamp(1, len(edges) - 1)
        gap = torch.minimum((xd - edges[at - 1]).abs(),
                            (xd - edges[at]).abs())
        near = int((gap <= HIST15_NEAR * edges.abs().max()).sum())
        moved = int((g_out[0] - c_out[0]).abs().sum())
        check(moved <= 2 * near, f"15a histogram: {moved} counts moved, "
              f"{near} values near an edge")
        ties += near
        moves += moved
        ratio15(g_out[1], c_out[1], OPS15_TOL["arith"], "15a histogram edges")
    print(f"ops15 histogram: 10^6 values, 100 bins and 40 given edges: "
          f"{moves} counts moved between bins (allowed: 2 x the {ties} "
          f"values within 1e-6 * max|edge| of an edge) [{card}]")
    return ("_histogram",)


def ops15_decompositions(mx, card):
    """gelqf and syevd at (16, 64, 64) in float64: L Q = A, Q Qt = I,
    U A Ut = diag(lambda), eigenvalues against the CPU's, and each row
    against the CPU's up to its sign (cuSOLVER and LAPACK may choose
    either)."""
    from incubator_mxnet_tpu_torch.ops import registry
    a = r15((16, 64, 64), 0, np.float64)
    s = spd15(64, 16)
    out = {}
    for dev in ("cpu", CARD15):
        low, q = registry.get("linalg_gelqf").fn({}, a.to(dev))
        u, lam = registry.get("linalg_syevd").fn({}, s.to(dev))
        out[dev] = [t.cpu() for t in (low, q, u, lam)]
    low, q, u, lam = out[CARD15]
    eye = torch.eye(64, dtype=torch.float64).expand(16, 64, 64)
    tol = OPS15_TOL["prod"]
    r = max(ratio15(low @ q, a, tol, "15a gelqf L Q"),
            ratio15(q @ q.transpose(1, 2), eye, tol, "15a gelqf Q Qt"),
            ratio15((q * out["cpu"][1]).sum(-1).abs(), torch.ones(16, 64),
                    tol, "15a gelqf rows"),
            ratio15(lam, out["cpu"][3], tol, "15a syevd eigenvalues"),
            ratio15(u @ s @ u.transpose(1, 2), torch.diag_embed(lam), tol,
                    "15a syevd U A Ut"),
            ratio15((u * out["cpu"][2]).sum(-1).abs(), torch.ones(16, 64),
                    tol, "15a syevd rows"))
    flips = int(((q * out["cpu"][1]).sum(-1) < 0).sum())
    print(f"ops15 gelqf/syevd: (16, 64, 64) float64, products and rows up "
          f"to sign within {r:.3f} of the tolerance; {flips} of 1024 "
          f"gelqf rows have the other sign than LAPACK's [{card}]")
    return ("linalg_gelqf", "linalg_syevd")


def ops15_random(mx, card):
    """10^6 draws of each random op on the card: mean and variance
    within 5 sigma of the distribution's, a KS test p > 1e-4 for the
    continuous ones, the same seed the same draws, shuffle a
    permutation."""
    from scipy import stats
    n = RANDOM15_DRAWS
    cases = [  # (nd.random name, params, mean, variance, scipy (dist, args))
        ("uniform", dict(low=-1.0, high=3.0), 1.0, 16 / 12,
         ("uniform", (-1.0, 4.0))),
        ("normal", dict(loc=2.0, scale=0.5), 2.0, 0.25, ("norm", (2.0, 0.5))),
        ("gamma", dict(alpha=2.5, beta=1.5), 3.75, 2.5 * 2.25,
         ("gamma", (2.5, 0, 1.5))),
        ("exponential", dict(lam=2.0), 0.5, 0.25, ("expon", (0, 0.5))),
        ("poisson", dict(lam=3.0), 3.0, 3.0, None),
        ("negative_binomial", dict(k=3, p=0.4), 4.5, 4.5 / 0.4, None),
        ("generalized_negative_binomial", dict(mu=2.0, alpha=0.5), 2.0, 4.0,
         None),
        ("randint", dict(low=-3, high=5), 0.5, 63 / 12, None),
    ]
    worst_z, worst_p = 0.0, 1.0
    for name, kw, mean, var, dist in cases:
        mx.random.seed(11)
        a = getattr(mx.nd.random, name)(shape=(n,), ctx=mx.gpu(0), **kw)
        mx.random.seed(11)
        b = getattr(mx.nd.random, name)(shape=(n,), ctx=mx.gpu(0), **kw)
        check(torch.equal(a.data, b.data), f"15a {name}: the same seed "
              "drew different values")
        x = a.data.double().cpu().numpy()
        z = moments15(x, mean, var, f"15a {name}")
        worst_z = max(worst_z, z)
        if dist is not None:
            # a frozen distribution's cdf: some scipy versions take a
            # named cdf's fast path and drop `args`
            p = stats.kstest(x, getattr(stats, dist[0])(*dist[1]).cdf).pvalue
            check(p > 1e-4, f"15a {name}: KS p {p:.3g}")
            worst_p = min(worst_p, p)
    ctx = mx.gpu(0)
    mu = mx.nd.array([0.0, 10.0], ctx=ctx)
    out = mx.nd.random.normal(mu, mx.nd.array([1.0, 0.1], ctx=ctx),
                              shape=(n // 2,))
    worst_z = max(worst_z, moments15(out.asnumpy()[1], 10.0, 0.01,
                                     "15a _sample_normal"))
    u = mx.nd.random.uniform(mx.nd.array([0.0, 2.0], ctx=ctx),
                             mx.nd.array([1.0, 6.0], ctx=ctx),
                             shape=(n // 2,))
    worst_z = max(worst_z, moments15(u.asnumpy()[1], 4.0, 16 / 12,
                                     "15a _sample_uniform"))
    g = mx.nd.random.gamma(mx.nd.array([2.0], ctx=ctx),
                           mx.nd.array([3.0], ctx=ctx), shape=(n,))
    worst_z = max(worst_z, moments15(g.asnumpy(), 6.0, 18.0,
                                     "15a _sample_gamma"))
    probs = np.array([[0.1, 0.6, 0.3], [0.5, 0.0, 0.5]], np.float32)
    s = mx.nd.random.multinomial(mx.nd.array(probs, ctx=ctx),
                                 shape=(n // 2,)).asnumpy()
    for row in range(2):
        for k in range(3):
            hit = (s[row] == k).astype(np.float64)
            worst_z = max(worst_z, moments15(hit, probs[row, k], probs[row, k]
                                             * (1 - probs[row, k]),
                                             "15a _sample_multinomial"))
    perm = mx.nd.random.shuffle(mx.nd.array(np.arange(n, dtype=np.float32),
                                            ctx=ctx)).asnumpy()
    check(np.array_equal(np.sort(perm), np.arange(n)),
          "15a shuffle: not a permutation")
    check(not np.array_equal(perm, np.arange(n)), "15a shuffle: identity")
    print(f"ops15 random: 12 samplers, 10^6 draws each on the card: worst "
          f"moment {worst_z:.2f} sigma (limit 5), lowest KS p {worst_p:.3g} "
          f"(limit 1e-4), the same seed the same draws, shuffle a "
          f"permutation [{card}]")
    return ("_random_uniform", "_random_normal", "_random_gamma",
            "_random_exponential", "_random_poisson",
            "_random_negative_binomial",
            "_random_generalized_negative_binomial", "_random_randint",
            "_sample_normal", "_sample_uniform", "_sample_gamma",
            "_sample_multinomial", "_shuffle")


def moments15(x, mean, var, what):
    """The larger of the mean's and the variance's distance from the
    distribution's, in standard errors; checked <= 5."""
    x = np.asarray(x, np.float64).ravel()
    n = x.size
    if var <= 0:
        check(x.mean() == mean, f"{what}: mean {x.mean()} vs {mean}")
        return 0.0
    zm = abs(x.mean() - mean) / math.sqrt(var / n)
    m4 = ((x - x.mean()) ** 4).mean()
    zv = abs(x.var() - var) / math.sqrt(max(m4 - var ** 2, 1e-300) / n) \
        if var > 0 else 0.0
    check(max(zm, zv) <= 5.0, f"{what}: mean {x.mean():.5g} var "
          f"{x.var():.5g} vs {mean:.5g} {var:.5g} ({max(zm, zv):.2f} sigma)")
    return max(zm, zv)


def metrics15(mx, card):
    """Each new metric's device_update on the card against its update on
    the CPU (F1's and MCC's on the host; the others' is device_update
    there) (rtol 1e-5: float32 sums in another order), three batches at
    10^4 rows."""
    rng = np.random.RandomState(SEED)
    worst = 0.0
    names = ("f1", "mcc", "mae", "mse", "rmse", "nll_loss", "pearsonr",
             "loss", "torch", "caffe")
    for name in names:
        host, dev = mx.metric.create(name), mx.metric.create(name)
        for _ in range(3):
            if name in ("f1", "mcc"):
                pred = rng.rand(10000, 2).astype(np.float32)
                label = rng.randint(0, 2, 10000).astype(np.float32)
            elif name == "nll_loss":
                p = rng.rand(10000, 10) + 0.01
                pred = (p / p.sum(1, keepdims=True)).astype(np.float32)
                label = rng.randint(0, 10, 10000).astype(np.float32)
            else:
                pred = rng.normal(0, 1, (10000, 4)).astype(np.float32)
                label = (pred + rng.normal(0, 0.5, pred.shape)).astype(
                    np.float32)
            host.update([mx.nd.array(label, ctx=mx.cpu())],
                        [mx.nd.array(pred, ctx=mx.cpu())])
            dev._accumulate(*dev.device_update(
                [torch.from_numpy(label).to(CARD15)],
                [torch.from_numpy(pred).to(CARD15)]))
        h, d = host.get()[1], dev.get()[1]
        r = abs(d - h) / (1e-5 * abs(h) + 1e-12)
        check(r <= 1.0, f"15a metric {name}: card {d!r} vs CPU {h!r}")
        worst = max(worst, r)
    print(f"ops15 metrics: {', '.join(names)}: device_update on the card "
          f"against update on the CPU, worst {worst:.3f} of rtol "
          f"1e-5 [{card}]")
    return worst


# -- 15b: BASELINE config #4 under every new optimizer -----------------------

def opt15_near(optimizer, state, prev_excuse):
    """{array key: elements excused}, unioned with `prev_excuse`, from
    the CPU's state after a step: the near ties of Signum (its new
    momentum within OPS15_NEAR * its max of 0: its sign sets the step)
    and Ftrl (|z| within that of lamda1: the weight is 0 below it), the
    weight excused."""
    out = dict(prev_excuse)
    if optimizer not in ("signum", "ftrl"):
        return out
    for key, v in state.items():
        if isinstance(key, str) or key[2] != 0:
            continue
        mag = np.abs(np.asarray(v, np.float64))
        edge = FTRL15_L1 if optimizer == "ftrl" else 0.0
        mask = np.abs(mag - edge) <= OPS15_NEAR * mag.max()
        out[key[1]] = mask | out.get(key[1], np.zeros_like(mask))
    return out


def opt15_ratio(got, ref, excuse):
    """(lstm_ratio outside the excused elements of each array, its name,
    the excused elements that were off by more than the tolerance, the
    elements excused, the elements compared, the elements off by more
    than the tolerance before the excuse)."""
    rtol, atol = PARITY_TOL
    worst, off, masked, total, over = (0.0, "none"), 0, 0, 0, 0
    for name, want in ref.items():
        want = np.asarray(want, np.float64)
        total += want.size
        bound = np.maximum(rtol * np.abs(want) + atol * np.abs(want).max(),
                           1e-30)
        err = np.abs(np.asarray(got[name], np.float64) - want) / bound
        over += int((err > 1.0).sum())
        mask = excuse.get(name)
        if mask is not None and mask.shape == err.shape:
            off += int((mask & (err > 1.0)).sum())
            masked += int(mask.sum())
            err = np.where(mask, 0.0, err)
        worst = max(worst, (float(err.max()), str(name)))
    return worst + (off, masked, total, over)


class opt15_float64:
    """A context in which RMSProp keeps its states in the weight's dtype
    (`states`; the optimizer keeps them in float32, as the JAX package's
    does) and SoftmaxOutput takes the softmax in its input's dtype
    (`softmax`; float32 for float64 data, as the JAX op does)."""

    def __init__(self, states=False, softmax=False):
        self.states, self.softmax = states, softmax

    def __enter__(self):
        from incubator_mxnet_tpu_torch import optimizer as topt
        from incubator_mxnet_tpu_torch.ops import loss_output
        self.saved = (vars(topt.RMSProp)["create_state"],
                      vars(loss_output._SoftmaxOutput)["forward"])
        if self.states:
            def create_state(opt, index, weight):
                return tuple(topt._zeros_like(weight)
                             for _ in range(3 if opt.centered else 1))
            topt.RMSProp.create_state = create_state
        if self.softmax:
            def forward(ctx, data, label, params):
                axis = 1 if params["multi_output"] else -1
                out = torch.softmax(data, dim=axis)
                ctx.save_for_backward(out, label)
                ctx.params, ctx.axis, ctx.in_dtype = params, axis, data.dtype
                return out
            loss_output._SoftmaxOutput.forward = staticmethod(forward)
        return self

    def __exit__(self, *exc):
        from incubator_mxnet_tpu_torch import optimizer as topt
        from incubator_mxnet_tpu_torch.ops import loss_output
        topt.RMSProp.create_state = self.saved[0]
        loss_output._SoftmaxOutput.forward = self.saved[1]
        return False


def opt15_module(mx, cfg, batches, values, optimizer, params, ctx, f64):
    """lstm_module for a 15b lane; with `f64` every bucket the batches
    reach bound and turned to float64 before a state is written in."""
    mod = lstm_module(mx, cfg, ctx, values, dict(LSTM15_OPT, **params),
                      optimizer=optimizer, f64=f64)
    for b in batches if f64 else ():
        mod.switch_bucket(b.bucket_key, b.provide_data, b.provide_label)
        as_float64(mod._curr_module)
    return mod


def opt15_run(mx, cfg, batches, values, optimizer, params, ctx, gate,
              teach=None):
    """One optimizer's parity steps on `ctx` in `gate`'s dtype (fp32,
    float64, or float64 with SoftmaxOutput's softmax in float64 too):
    (losses, the state after each step, the module).  With `teach` (the
    CPU run's states) each step starts from the CPU's state after the
    step before, 11a's teacher."""
    with opt15_float64(softmax=gate == "float64 softmax"):
        mod = opt15_module(mx, cfg, batches, values, optimizer, params, ctx,
                           gate != "fp32")
        metric = mx.metric.Perplexity(0)
        losses, states = [], []
        for k, b in enumerate(batches):
            mod.switch_bucket(b.bucket_key, b.provide_data, b.provide_label)
            if teach is not None and k:
                lstm_set_state(mx, mod, teach[k - 1])
            mod.fit_step(b, metric)
            losses.append(lstm_loss(mod, b))
            states.append(lstm_state(mx, mod))
    steps = sum(m._fused_step.steps for m in mod._buckets.values())
    check(steps == len(batches), f"15b {optimizer}: the fused step took "
          f"{steps} of {len(batches)} steps")
    return losses, states, mod


def opt15_compare(optimizer, run, ref, teacher):
    """(loss rel err, opt15_ratio) of `run` against the CPU's run `ref`:
    free running the last step's state under the near ties of every
    step, or (`teacher`) each step's state under that step's (the worst
    share and its array; the elements off summed over the steps, the
    elements excused in the step that excused most, the elements
    compared in a step, the elements off before the excuse summed)."""
    losses, states = run[:2]
    cpu_losses, cpu_states = ref[:2]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu_losses))
    if teacher:
        rs = [opt15_ratio(s, r, opt15_near(optimizer, r, {}))
              for s, r in zip(states, cpu_states)]
        return loss_err, max(r[:2] for r in rs) + (
            sum(r[2] for r in rs), max(r[3] for r in rs), rs[0][4],
            sum(r[5] for r in rs))
    excuse = {}
    for r in cpu_states:
        excuse = opt15_near(optimizer, r, excuse)
    return loss_err, opt15_ratio(states[-1], cpu_states[-1], excuse)


def opt15_lane(mx, cfg, batches, values, label, optimizer, params, card):
    """One optimizer through config #4's parity steps under 11a's gate,
    card vs CPU from the same parameters and batches, free running and
    each step from the CPU's state, in fp32 (TF32 off) and, unless the
    lane is held in fp32 (OPT15_GATE), in the dtype that holds it (and,
    for RMSProp centered, float64 as shipped, printed).  Then, on a lane
    held in fp32, its card run's LSTM15_TIMED bucket-60 steps timed; the
    state round trip of the card run.  SGLD: `sgld15`."""
    from incubator_mxnet_tpu_torch import optimizer as topt
    gate = OPT15_GATE.get(label, "float64")
    out = {"gate": gate, "ties": 0, "masked": 0}
    if optimizer == "sgld":
        mod = lstm_module(mx, cfg, mx.gpu(0), values, dict(LSTM15_OPT),
                          optimizer="sgld")
        metric = mx.metric.Perplexity(0)
        lane_losses = []
        for b in batches:
            mod.fit_step(b, metric)
            lane_losses.append(lstm_loss(mod, b))
        steps = sum(m._fused_step.steps for m in mod._buckets.values())
        check(steps == 0, f"15b {label}: the fused step took {steps} "
              f"steps of an optimizer that draws")
        out.update(sgld15(mx, cfg, batches, values, card),
                   declined=len(batches))
    else:
        # fp32, or the float64 lanes as shipped and as held
        for dtype in dict.fromkeys(("fp32",) if gate == "fp32" else
                                   ("float64", gate)):
            ref = opt15_run(mx, cfg, batches, values, optimizer, params,
                            mx.cpu(), dtype)
            free = opt15_run(mx, cfg, batches, values, optimizer, params,
                             mx.gpu(0), dtype)
            teacher = opt15_run(mx, cfg, batches, values, optimizer, params,
                                mx.gpu(0), dtype, teach=ref[1])
            out[dtype] = {"card": opt15_compare(optimizer, free, ref, False),
                          "teacher": opt15_compare(optimizer, teacher, ref,
                                                   True)}
            if dtype == gate:
                lane_losses, mod = free[0], free[2]
        for name, (loss_err, worst) in out[gate].items():
            check(loss_err <= PARITY_TOL[0], f"15b {label} {gate} {name}: "
                  f"loss rel err {loss_err:.3g}")
            check(worst[0] <= 1.0, f"15b {label} {gate} {name}: {worst[1]} "
                  f"off by {worst[0]:.3f} of the tolerance")
            out["ties"] = max(out["ties"], worst[2])
            out["masked"] = max(out["masked"], worst[3])
        out["declined"] = 0
    check(all(math.isfinite(x) for x in lane_losses), f"15b {label}: "
          "loss not finite")
    out["step_ms"] = out["tokens_s"] = None
    if gate == "fp32" or optimizer == "sgld":
        b60 = next(b for b in batches
                   if b.bucket_key == max(cfg["buckets"]))
        metric = mx.metric.Perplexity(0)
        ms = []
        for _ in range(LSTM15_TIMED):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.fit_step(b60, metric)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = statistics.median(ms)
        out["tokens_s"] = cfg["batch"] * max(cfg["buckets"]) \
            / out["step_ms"] * 1e3
    upd = mod._buckets[mod._default_bucket_key]._updater
    blob = b"".join(bytes(p) for p in topt.dumps_states(
        (upd.states, upd.optimizer)))
    states, opt = topt.loads_states(blob)
    same = all(torch.equal(a.data.cpu(), b.data.cpu())
               for i in upd.states
               for a, b in zip(*(s if isinstance(s, tuple) else (s,)
                                 for s in (upd.states[i], states[i])))
               if a is not None)
    check(same and type(opt) is type(upd.optimizer) and
          getattr(opt, "m_schedule", None) == getattr(upd.optimizer,
                                                      "m_schedule", None),
          f"15b {label}: the state round trip changed the states")
    out["blob_mb"] = len(blob) / 1e6
    return out


def opt15_witness(mx, cfg, batches, values, params):
    """RMSProp's float64 lane card vs CPU free running, with its float32
    states (`opt15_float64`) made float64, and with its states and the
    softmax: {variant: (worst share, its array, elements off)}, beside
    the lanes as shipped and with the float64 softmax alone."""
    out = {}
    for variant, softmax in (("float64 states", False), ("both", True)):
        with opt15_float64(states=True):
            runs = [opt15_run(mx, cfg, batches, values, "rmsprop", params,
                              ctx, "float64 softmax" if softmax else
                              "float64") for ctx in (mx.cpu(), mx.gpu(0))]
        out[variant] = opt15_ratio(runs[1][1][-1], runs[0][1][-1], {})
    return out


def sgld15(mx, cfg, batches, values, card):
    """SGLD over the parity steps: the CPU free running, the card each
    step from the CPU's parameters after the step before (11a's
    teacher), in fp32 (a reading) and in float64 (held).  Each step's
    gradient to 11a's tolerance, and the update less its deterministic
    part, lr / 2 (g + wd w), held to N(0, lr) by mean and variance over
    every parameter, on both devices."""
    out = {"z": 0.0}
    lr = LSTM15_OPT["learning_rate"]
    for dtype in ("fp32", "float64"):
        grads, cpu_states = {}, []
        for dev_name, ctx in (("cpu", mx.cpu()), ("card", mx.gpu(0))):
            mod = opt15_module(mx, cfg, batches, values, "sgld", {}, ctx,
                               dtype == "float64")
            noise, gs = [], []
            for k, b in enumerate(batches):
                mod.switch_bucket(b.bucket_key, b.provide_data,
                                  b.provide_label)
                if dev_name == "card" and k:
                    lstm_set_state(mx, mod, cpu_states[k - 1])
                mod.forward_backward(b)
                cur = mod._curr_module
                group = cur._exec_group
                before = [w[0].data.detach().double().cpu().clone()
                          for w in group.param_arrays]
                g = [gr[0].data.detach().double().cpu() * LSTM15_OPT[
                    "rescale_grad"] for gr in group.grad_arrays]
                wds = [cur._optimizer._get_wd(i)
                       for i in range(len(group.param_names))]
                mod.update()
                after = [w[0].data.detach().double().cpu()
                         for w in group.param_arrays]
                for w0, w1, gg, wdi in zip(before, after, g, wds):
                    noise.append((w1 - (w0 - lr / 2 * (gg + wdi * w0))
                                  ).ravel())
                gs.append({n: x.numpy()
                           for n, x in zip(group.param_names, g)})
                if dev_name == "cpu":
                    cpu_states.append(lstm_state(mx, mod))
            grads[dev_name] = gs
            x = torch.cat(noise).numpy()
            out["z"] = max(out["z"], moments15(
                x, 0.0, lr, f"15b sgld noise ({dtype}, {dev_name})"))
            out[f"noise_{dev_name}"] = (float(x.mean()), float(x.var()))
        out[dtype] = max(lstm_ratio(c, r) + (k + 1,) for k, (c, r) in
                         enumerate(zip(grads["card"], grads["cpu"])))
    worst = out["float64"]
    check(worst[0] <= 1.0, f"15b sgld: step {worst[2]} float64 gradient "
          f"{worst[1]} off by {worst[0]:.3f} of the tolerance")
    return out


def opt15_reading(res, dtype):
    """One dtype's parity, as printed."""
    (lc, wc), (lt, wt) = res[dtype]["card"], res[dtype]["teacher"]
    line = (f"{dtype} loss rel err {lc:.2e} free / {lt:.2e} from the CPU's "
            f"state; parameters and states worst {wc[0]:.2e} free / "
            f"{wt[0]:.2e} each step "
            f"({wt[1] if wt[0] >= wc[0] else wc[1]})")
    if wc[3] or wt[3]:
        line += (f"; near ties: {wc[3]} of {wc[4]} elements excused free / "
                 f"{wt[3]} in a step, {wc[2]} / {wt[2]} of them off")
    return line


def lstm15(mx, card):
    """15b: BASELINE config #4 at its published widths under every new
    optimizer; the four that take ``momentum`` through the example's own
    params with --mom 0.9, the others through `fit`'s optimizer name
    with the example's params less momentum (which they refuse, as the
    JAX package's do)."""
    from incubator_mxnet_tpu_torch import optimizer as topt
    cfg = LSTM_CFG
    corpus = lstm_corpus(cfg)
    pool = {}
    for b in lstm_iter(mx, corpus, cfg):
        pool.setdefault(b.bucket_key, []).append(b)
    batches = [pool[k].pop(0) for k in LSTM15_PARITY_KEYS]
    values = lstm_state(mx, lstm_module(mx, cfg, mx.cpu()))
    for name in REFUSE15:
        try:
            topt.create(name, momentum=0.9)
        except TypeError as e:
            check(str(e) == "Optimizer.__init__() got an unexpected "
                  "keyword argument 'momentum'", f"15b {name}: {e}")
        else:
            check(False, f"15b: {name} took momentum")
    out = {}
    for label, name, params, flag in LSTM15_LANES:
        t0 = time.perf_counter()
        res = opt15_lane(mx, cfg, batches, values, label, name, params, card)
        out[label] = res
        if name == "sgld":
            parity = (f"{len(batches)} steps from the CPU's state: "
                      f"gradients held in "
                      f"float64, worst {res['float64'][0]:.2e} of the "
                      f"tolerance (step {res['float64'][2]}, "
                      f"{res['float64'][1]}); fp32 reading "
                      f"{res['fp32'][0]:.4f} (step {res['fp32'][2]}, "
                      f"{res['fp32'][1]}); noise N(0, lr) within "
                      f"{res['z']:.2f} sigma (card mean "
                      f"{res['noise_card'][0]:.2e} var "
                      f"{res['noise_card'][1]:.5f}, lr "
                      f"{LSTM15_OPT['learning_rate']})")
        else:
            keys = "/".join(map(str, LSTM15_PARITY_KEYS))
            parity = (f"{len(batches)} steps ({keys}), held in "
                      f"{res['gate']}: "
                      + opt15_reading(res, res["gate"]))
        timed = "not timed (no fp32 run)" if res["step_ms"] is None else \
            f"{res['step_ms']:.2f} ms = {res['tokens_s']:.0f} tokens/s"
        print(f"lstm15 {label}: {'--optimizer ' if flag else 'fit(optimizer='}"
              f"{name}{' --mom 0.9' if flag else ')'}: card vs CPU: "
              f"{parity}; fused step declined {res['declined']}; bucket-60 "
              f"step {timed}; state round trip {res['blob_mb']:.1f} MB "
              f"equal; {time.perf_counter() - t0:.1f} s [{card}]")
        if label == "rmsprop centered":
            t0 = time.perf_counter()
            w = opt15_witness(mx, cfg, batches, values, params)
            w = {"as shipped (float32 states and softmax)":
                 res["float64"]["card"][1],
                 "float64 softmax": res["float64 softmax"]["card"][1], **w}
            print(f"lstm15 {label} witness, float64 free running card vs "
                  f"CPU, elements off 11a's tolerance: " + "; ".join(
                      f"{k} {v[5]} (worst {v[0]:.3g}, {v[1]})"
                      for k, v in w.items())
                  + f"; {time.perf_counter() - t0:.1f} s [{card}]")
            res["witness"] = w
    return out


# -- 15c: train_mnist's mlp as a SequentialModule -----------------------------

def seq15_modules(mx, ctx, lr_mult=SEQ15_LR_MULT):
    """(SequentialModule of the split mlp, one Module of the whole): the
    split of upstream's example/module/sequential_module.py, fc1 and its
    input made under AttrScope(lr_mult)."""
    s = mx.sym
    with mx.AttrScope(lr_mult=lr_mult):
        data = s.Flatten(s.Variable("data"))
        fc1 = s.FullyConnected(data, name="fc1", num_hidden=128)
    act1 = s.Activation(fc1, name="relu1", act_type="relu")

    def head(x):
        fc2 = s.FullyConnected(x, name="fc2", num_hidden=64)
        act2 = s.Activation(fc2, name="relu2", act_type="relu")
        fc3 = s.FullyConnected(act2, name="fc3", num_hidden=10)
        return s.SoftmaxOutput(fc3, name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(act1, label_names=[], context=ctx))
    seq.add(mx.mod.Module(head(s.Variable("data")), context=ctx),
            take_labels=True, auto_wiring=True)
    return seq, mx.mod.Module(head(act1), context=ctx)


def seq15_init(mx):
    return mx.init.Mixed([".*fc1.*", ".*"],
                         [mx.init.Orthogonal(), mx.init.MSRAPrelu()])


def seq15_metric(mx):
    def err(label, pred):
        return float((pred.argmax(1) != label).mean())
    return mx.metric.create(["acc", "nll_loss", err])


def seq15_setup(mx, mod, shapes):
    mod.bind(*shapes)
    mx.random.seed(SEED)
    mod.init_params(initializer=seq15_init(mx))
    mod.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": TRAIN_LR, "momentum": TRAIN_MOMENTUM})


def seq15_state(mod):
    """({name: parameter}, {name: momentum}) of a Module or of every
    module of a SequentialModule, as numpy."""
    mods = getattr(mod, "_modules", [mod])
    params, moms = {}, {}
    for m in mods:
        names = m._exec_group.param_names
        params.update({n: v.asnumpy() for n, v in m.get_params()[0].items()})
        moms.update({names[i]: s.asnumpy()
                     for i, s in m._updater.states.items()})
    return params, moms


def seq15_set_state(mod, state):
    params, moms = state
    for m in getattr(mod, "_modules", [mod]):
        names = m._exec_group.param_names
        m.set_params({n: params[n] for n in names}, {})
        for i, n in enumerate(names):
            m._updater.states[i]._set_data(torch.from_numpy(moms[n]))


def seq15_steps(mx, ctx, batches, split=True, teacher=None, monitor=None):
    """SEQ15_STEPS steps of the mlp (split or whole) on `ctx` from the
    Mixed initializer under mx.random.seed(SEED), through the per-batch
    path with `monitor` (tic, forward_backward, update, metric, toc) as
    fit runs it; with `teacher`, step k from its state before it.
    Returns (losses, states before and after each step, monitor rows,
    the fc1 weight after and before the first step and its gradient)."""
    seq, one = seq15_modules(mx, ctx)
    mod = seq if split else one
    shapes = ([("data", (TRAIN_BATCH, 1, 28, 28))],
              [("softmax_label", (TRAIN_BATCH,))])
    seq15_setup(mx, mod, shapes)
    rows = {}
    if monitor is not None:
        mod.install_monitor(monitor)
        monitor.toc_print = lambda: [
            rows.setdefault((n, k), float(v.strip()))
            for n, k, v in monitor.toc()]
    metric = seq15_metric(mx)
    losses, states, first = [], [seq15_state(mod)], None
    for k, batch in enumerate(batches):
        if teacher is not None and k:
            seq15_set_state(mod, teacher[k])
        if monitor is not None:
            monitor.tic()
        mod.forward_backward(batch)
        if k == 0:
            m1 = mod._modules[0] if split else mod
            i = m1._exec_group.param_names.index("fc1_weight")
            grad = m1._exec_group.grad_arrays[i][0].asnumpy()
            w0 = states[0][0]["fc1_weight"]
        mod.update()
        mod.update_metric(metric, batch.label)
        if monitor is not None:
            monitor.toc_print()
        losses.append(cross_entropy(mod.get_outputs()[0], batch.label[0]))
        states.append(seq15_state(mod))
        if k == 0:
            first = (states[1][0]["fc1_weight"], w0, grad)
    return losses, states, rows, first


def seq15_ratio(got, ref, tol):
    rtol, atol = tol
    return max(((float((np.abs(got[n] - c) / np.maximum(
        rtol * np.abs(c) + atol * np.abs(c).max(), 1e-30)).max()), n)
        for n, c in ref.items()), default=(0.0, "none"))


def seq15(mx, card):
    """15c: the mlp as a SequentialModule under TPU_PALLAS: K1 in both
    modules, parity with one Module and with the CPU, the monitor, the
    AttrScope's half rate, the Mixed initializer bitwise, then 5 epochs
    through fit; a PythonLossModule stage for one epoch."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    train, val = mnist_iters(mx)
    batches = [next(train) for _ in range(SEQ15_STEPS)]
    cpu_mon, card_mon = mx.Monitor(1), mx.Monitor(1)
    fc_relu.launches = 0
    g_loss, g_states, g_rows, first = seq15_steps(
        mx, mx.gpu(0), batches, monitor=card_mon)
    launches = fc_relu.launches
    check(launches == 2 * SEQ15_STEPS, f"15c: K1 launched {launches} times "
          f"in {SEQ15_STEPS} steps, want 2 a train forward")
    c_loss, c_states, c_rows, _ = seq15_steps(mx, mx.cpu(), batches,
                                              monitor=cpu_mon)
    o_loss, o_states, _, _ = seq15_steps(mx, mx.gpu(0), batches,
                                         split=False)
    _, t_states, _, _ = seq15_steps(mx, mx.gpu(0), batches,
                                    teacher=c_states)
    init_equal = all(np.array_equal(g_states[0][0][n], c_states[0][0][n])
                     for n in c_states[0][0])
    check(init_equal, "15c: the Mixed initializer drew other parameters on "
          "the card than on the CPU")
    # the split against the whole, on the card
    split_err = max(abs(a - b) / abs(b) for a, b in zip(g_loss, o_loss))
    split_w = max(max(seq15_ratio(g[0], o[0], SEQ15_TOL),
                      seq15_ratio(g[1], o[1], SEQ15_TOL))
                  for g, o in zip(g_states, o_states))
    check(split_err <= SEQ15_TOL[0] and split_w[0] <= 1.0,
          f"15c: the SequentialModule vs one Module: loss {split_err:.3g}, "
          f"{split_w[1]} at {split_w[0]:.3f} of the tolerance")
    # card against CPU (phase 6's gate)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    free = param_ratio(g_states[-1][0], c_states[-1][0])
    held_ = max(max(param_ratio(t[0], c[0]), param_ratio(t[1], c[1]))
                for t, c in zip(t_states[1:], c_states[1:]))
    check(loss_err <= PARITY_TOL[0] and free[0] <= 1 and held_[0] <= 1,
          f"15c: card vs CPU loss {loss_err:.3g}, free {free}, held {held_}")
    # the monitor: every output and argument statistic of every step
    check(set(g_rows) == set(c_rows) and len(g_rows) > 0,
          "15c: the card's and the CPU's monitors saw other names")
    keys = sorted(c_rows)
    mon = op_ratio([g_rows[k] for k in keys], [c_rows[k] for k in keys],
                   MON15_TOL)
    check(mon <= 1.0, f"15c: monitor statistics at {mon:.3f} of the "
          "tolerance")
    outs = sorted({n for _, n in c_rows if n.endswith("_output")})
    # the AttrScope: fc1's first update is -lr * 0.5 * rescale * g (SGD
    # with momentum starts from a zero momentum; wd 0), held on the
    # weight (a full-rate step would be off by ~1e-3 of it)
    w1, w0, grad = first
    want = w0 - TRAIN_LR * SEQ15_LR_MULT * grad / TRAIN_BATCH
    half = op_ratio(w1, want, SEQ15_TOL)
    check(half <= 1.0, f"15c: fc1's first update is not half the rate "
          f"({half:.3f} of the tolerance)")
    print(f"seq15 mlp as SequentialModule (TPU_PALLAS): {SEQ15_STEPS} steps "
          f"K1 launches {launches} (2 a train forward: fc1+relu1 in module "
          f"1, fc2+relu2 in module 2); vs one Module on the card: loss rel "
          f"err {split_err:.2e}, parameters and momenta {split_w[0]:.3f} of "
          f"rtol 1e-5 + 1e-6*max; vs the CPU: loss {loss_err:.2e}, free "
          f"{free[0]:.3f}, each step from the CPU's state {held_[0]:.3f} of "
          f"the tolerance; Mixed(Orthogonal, MSRAPrelu) parameters bitwise "
          f"the CPU's; monitor {len(keys)} statistics ({', '.join(outs)} "
          f"and the arguments) at {mon:.3f} of rtol 1e-4 + 1e-5*max; fc1 "
          f"under AttrScope(lr_mult=0.5) updated at half rate "
          f"({half:.3f}) [{card}]")
    # TRAIN_EPOCHS epochs through fit, no monitor
    train, val = mnist_iters(mx)
    seq, _ = seq15_modules(mx, mx.gpu(0))
    fc_relu.launches = 0
    ticks = []
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    seq.fit(train, eval_data=val, optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": TRAIN_MOMENTUM},
            initializer=seq15_init(mx), num_epoch=TRAIN_EPOCHS,
            eval_metric=seq15_metric(mx),
            batch_end_callback=lambda p: ticks.append(time.perf_counter()))
    wall = time.perf_counter() - t0
    fit_launches = fc_relu.launches
    acc = seq.score(val, "acc")[0][1]
    steps = len(ticks)
    step_ms = statistics.median(np.diff(ticks)) * 1e3
    evals = TRAIN_EPOCHS * -(-(TRAIN_IMAGES - TRAIN_SPLIT) // TRAIN_BATCH)
    check(fit_launches == 2 * (steps + evals), f"15c fit: K1 launched "
          f"{fit_launches} times for {steps} train and {evals} eval "
          "forwards")
    check(acc > 0.95, f"15c: validation accuracy {acc:.4f} <= 0.95")
    print(f"seq15 fit: {TRAIN_EPOCHS} epochs ({steps} steps) in {wall:.1f} "
          f"s, step median {step_ms:.3f} ms = {TRAIN_BATCH / step_ms * 1e3:.0f}"
          f" samples/s, K1 {fit_launches} launches, validation accuracy "
          f"{acc:.4f} (> 0.95) [{card}]")
    loss_curve = pyloss15(mx, card)
    return {"k1_launches": launches + fit_launches, "accuracy": acc,
            "step_ms": step_ms, "split_worst": split_w[0],
            "monitor_worst": mon, "pyloss": loss_curve}


def pyloss15(mx, card):
    """A PythonLossModule (squared error against the one-hot label, its
    gradient from numpy) as the last stage of a SequentialModule after
    the mlp's layers, one epoch on the card: finite and falling."""
    s = mx.sym
    data = s.Flatten(s.Variable("data"))
    net = s.Activation(s.FullyConnected(data, num_hidden=128, name="fc1"),
                       act_type="relu")
    net = s.FullyConnected(net, num_hidden=10, name="fc2")

    def grad(scores, labels):
        sc = scores.asnumpy()
        one = np.zeros_like(sc)
        one[np.arange(len(sc)), labels.asnumpy().astype(int)] = 1.0
        return (sc - one) / len(sc)

    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(net, label_names=[], context=mx.gpu(0)))
    seq.add(mx.mod.PythonLossModule(grad_func=grad), take_labels=True,
            auto_wiring=True)
    train, _ = mnist_iters(mx)
    curve = []

    def sq_err(label, pred):
        one = np.zeros_like(pred)
        one[np.arange(len(pred)), label.astype(int)] = 1.0
        return float(0.5 * ((pred - one) ** 2).sum(1).mean())
    metric = mx.metric.np(sq_err)

    def on_batch(p):
        curve.append(p.eval_metric.get()[1])
        p.eval_metric.reset()

    mx.random.seed(SEED)
    seq.fit(train, num_epoch=1, optimizer="sgd", eval_metric=metric,
            optimizer_params={"learning_rate": 0.5},
            initializer=mx.init.Xavier(), batch_end_callback=on_batch)
    first, last = np.mean(curve[:5]), np.mean(curve[-5:])
    check(all(math.isfinite(v) for v in curve) and last < first,
          f"15c PythonLossModule: loss {first:.4f} -> {last:.4f}")
    print(f"seq15 PythonLossModule stage: one epoch ({len(curve)} batches) "
          f"on the card, 0.5 |scores - one-hot|^2 over the first 5 batches "
          f"{first:.4f} -> last 5 {last:.4f} [{card}]")
    return (first, last)


def registry_phase(card):
    """Phase 15; returns the numbers of the summary line and K1's
    launches on 15c.  K2 and K3 must not run; K1 runs only in 15c."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    for wrapper in (fc_relu, flash_fwd, flash_fwd_stream):
        wrapper.launches = 0
    out = {}
    t0 = time.perf_counter()
    out["ops"] = ops15_registry(mx, card)
    out["metrics"] = metrics15(mx, card)
    print(f"phase 15a: {time.perf_counter() - t0:.1f} s")
    check([fc_relu.launches, flash_fwd.launches, flash_fwd_stream.launches]
          == [0, 0, 0], "15a: a K1/K2/K3 kernel ran")
    t0 = time.perf_counter()
    out["lstm"] = lstm15(mx, card)
    print(f"phase 15b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    old = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    try:
        out["seq"] = seq15(mx, card)
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        if old is not None:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    print(f"phase 15c: {time.perf_counter() - t0:.1f} s")
    check([flash_fwd.launches, flash_fwd_stream.launches] == [0, 0],
          "phase 15: K2/K3 ran")
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 16: the training API's stragglers and the serving path's edges
# ---------------------------------------------------------------------------

FF16_STEPS = 8                  # 16a: FeedForward's steps (one epoch)
FF16_TOL = (1e-5, 1e-6)         # 16a: the adapter against one Module
FF16_RAGGED = 500               # 16a: predict's rows (a tail of 52 of 64)
CKPT16 = dict(epochs=2, period=20)   # 16b: Module.fit's elastic snapshots
SERVE16_SIZES = (1, 7, 32, 3, 16, 2, 29, 8, 5, 12)   # 16b: request rows
C16_EXACT = 1e-6                # 16d: the C program against in-process
RESUME16 = dict(sentences=400, buckets=(10, 20, 40, 60), epochs=2,
                period=4, kill_after=7, term_after=16)    # 16e: 22 batches
GRAD16 = {"fc": (2, 4, 3), "conv": (1, 2, 5, 5, 2, 3)}   # 16f's small ops


def k1_held(m, where):
    """Fail unless phase 3 held K1 against fc_relu_ref at the mlp's fc1
    and fc2 with M = m."""
    held = set(MLP_K1) | {shape for shape, _, _ in PATH_K1}
    check(all((m, k, n) in held for (k, n), _ in MLP_LAYERS),
          f"{where}: K1's mlp shapes at M={m} were not held against "
          "fc_relu_ref in phase 3")


def ff16_data(mx):
    """The first FF16_STEPS batches' images of train_mnist's training
    set, and the validation images."""
    x, y = mx.test_utils.get_mnist_like(TRAIN_IMAGES)
    n = FF16_STEPS * TRAIN_BATCH
    return x[:n], y[:n], x[TRAIN_SPLIT:]


def ff16_fit(mx, ctx, x, y, feedforward=True):
    """One epoch (FF16_STEPS steps) of the mlp from Xavier under one
    seed, shuffled by numpy seeded the same: through FeedForward.fit, or
    through Module.fit on the iterator FeedForward builds.  Returns
    (model or module, the loss of each step, parameters after)."""
    losses = []

    def on_batch(p):
        losses.append(p.eval_metric.get()[1])
        p.eval_metric.reset()
    opt = {"learning_rate": TRAIN_LR, "momentum": TRAIN_MOMENTUM}
    np.random.seed(SEED)
    mx.random.seed(SEED)
    if feedforward:
        model = mx.model.FeedForward(
            mlp_symbol(mx), ctx=ctx, num_epoch=1, optimizer="sgd",
            initializer=mx.initializer.Xavier(),
            numpy_batch_size=TRAIN_BATCH, **opt)
        model.fit(x, y, eval_metric="ce", batch_end_callback=on_batch)
        params = model.arg_params
    else:
        model = mx.mod.Module(mlp_symbol(mx), context=ctx)
        model.fit(mx.io.NDArrayIter(x, y, batch_size=TRAIN_BATCH,
                                    shuffle=True),
                  num_epoch=1, optimizer="sgd", optimizer_params=opt,
                  initializer=mx.initializer.Xavier(), eval_metric="ce",
                  batch_end_callback=on_batch)
        params = model.get_params()[0]
    return model, losses, {k: v.asnumpy() for k, v in params.items()}


def ff16(mx, card, workdir):
    """16a: FeedForward on config #1's mlp under TPU_PALLAS."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    x, y, val = ff16_data(mx)
    k1_held(TRAIN_BATCH, "16a")
    fc_relu.launches = 0
    model, g_loss, g_params = ff16_fit(mx, mx.gpu(0), x, y)
    launches = fc_relu.launches
    check(launches == 2 * FF16_STEPS, f"16a: K1 launched {launches} times "
          f"in {FF16_STEPS} FeedForward steps, want 2 a train forward")
    mod, m_loss, m_params = ff16_fit(mx, mx.gpu(0), x, y, feedforward=False)
    _, c_loss, c_params = ff16_fit(mx, mx.cpu(), x, y)
    vs_mod = max(op_ratio(g_loss, m_loss, FF16_TOL),
                 lstm_ratio(g_params, m_params, FF16_TOL)[0])
    check(vs_mod <= 1.0, f"16a: FeedForward vs Module on the card at "
          f"{vs_mod:.3f} of rtol 1e-5 + 1e-6*max")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(g_loss, c_loss))
    free = param_ratio(g_params, c_params)
    check(loss_err <= PARITY_TOL[0] and free[0] <= 1.0,
          f"16a: card vs CPU loss {loss_err:.3g}, parameters {free}")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "ff")
        model.save(prefix, 1)
        loaded = mx.model.FeedForward.load(prefix, 1, ctx=mx.gpu(0),
                                           numpy_batch_size=TRAIN_BATCH)
        fc_relu.launches = 0
        got = loaded.predict(val)
        pred_launches = fc_relu.launches
    want = mod.predict(mx.io.NDArrayIter(val, batch_size=TRAIN_BATCH))
    saved = op_ratio(got, want.asnumpy(), FF16_TOL)
    check(saved <= 1.0, f"16a: loaded FeedForward.predict vs "
          f"Module.predict at {saved:.3f} of the tolerance")
    ragged = loaded.predict(val[:FF16_RAGGED])
    rows = np.concatenate([loaded._module.predict(val[i:i + 1]).asnumpy()
                           for i in range(FF16_RAGGED)])
    tail = op_ratio(ragged, rows, SERVE_TRAIN_TOL)
    check(ragged.shape == (FF16_RAGGED, 10) and tail <= 1.0,
          f"16a: ragged predict {ragged.shape} vs row by row at "
          f"{tail:.3f} of rtol 1e-4 + 1e-5*max")
    batches = -(-len(val) // TRAIN_BATCH)
    check(pred_launches == 2 * batches, f"16a: K1 launched {pred_launches} "
          f"times in {batches} predict batches")
    print(f"ff16 FeedForward mlp (TPU_PALLAS): {FF16_STEPS} steps K1 "
          f"{launches} launches (2 a train forward); vs Module.fit on the "
          f"card {vs_mod:.3f} of rtol 1e-5 + 1e-6*max; vs the CPU loss "
          f"{loss_err:.2e}, parameters {free[0]:.3f} of phase 6's gate; "
          f"save/load/predict vs Module.predict {saved:.3f}; a ragged "
          f"{FF16_RAGGED} rows (tail {FF16_RAGGED % TRAIN_BATCH} of "
          f"{TRAIN_BATCH}) vs row by row {tail:.3f} of rtol 1e-4 + "
          f"1e-5*max [{card}]")
    return {"k1_launches": launches + pred_launches, "vs_module": vs_mod}


def serve16_requests(images):
    cuts, k = [0], 0
    while cuts[-1] < len(images):
        cuts.append(min(len(images),
                        cuts[-1] + SERVE16_SIZES[k % len(SERVE16_SIZES)]))
        k += 1
    return [images[a:b] for a, b in zip(cuts, cuts[1:])]


def serve16_train(mx, root):
    """The mlp trained through Module.fit(checkpoint_dir=) on the card,
    then a torn checkpoint newer than every valid one (a copy of the
    newest with its arrays shard damaged).  Returns (module, newest
    valid step)."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    train, _ = mnist_iters(mx)
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.gpu(0))
    mx.random.seed(SEED)
    mod.fit(train, num_epoch=CKPT16["epochs"], optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": TRAIN_MOMENTUM},
            initializer=mx.initializer.Xavier(), checkpoint_dir=root,
            checkpoint_period=CKPT16["period"])
    newest = ckpt.latest(root)
    step = ckpt.load(newest).step
    torn = os.path.join(root, ckpt.manifest.checkpoint_dirname(step + 1000))
    shutil.copytree(newest, torn)
    with open(os.path.join(torn, ckpt.snapshot.ARRAYS_SHARD), "r+b") as f:
        f.seek(256)
        f.write(b"\xa5" * 64)
    check(ckpt.latest(root) == newest, "16b: latest() took the torn "
          "checkpoint")
    return mod, step


def serve16(mx, card, workdir):
    """16b: the trained mlp served from its checkpoint directory (a torn
    newer one beside it) through ModelServer.load_model(symbol_file=,
    checkpoint_dir=), partitioned by TPU_PALLAS; 16c: the breaker and
    retry scripts on the card; returns the numbers and the server's
    answers."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    root = tempfile.mkdtemp(dir=workdir, prefix="ckpt16-")
    out = {}
    try:
        mod, step = serve16_train(mx, root)
        symbol_file = os.path.join(root, "mlp-symbol.json")
        mx.subgraph.partition_graph(mlp_symbol(mx), "TPU_PALLAS").save(
            symbol_file)
        _, val = mnist_iters(mx)
        images = val.data[0][1]
        want = mod.predict(val).asnumpy()
        reqs = serve16_requests(images)
        for m in SERVE16_BUCKETS:
            k1_held(m, "16b")
        srv = mx.serving.ModelServer(max_queue_latency_ms=2.0,
                                     ctx=mx.gpu(0))
        try:
            srv.load_model("mlp", symbol_file=symbol_file,
                           checkpoint_dir=root,
                           data_shapes=[("data", (1, 1, 28, 28))],
                           buckets=SERVE16_BUCKETS)
            snap = ckpt.load(ckpt.latest(root))
            held_ = srv.model("mlp")._infer._state[0]
            equal = all(np.array_equal(held_[k[4:]].cpu().numpy(), v)
                        for k, v in snap.arrays.items())
            check(equal and snap.step == step, "16b: the served parameters "
                  "are not the newest valid snapshot's")
            fc_relu.launches = 0
            futs = [srv.submit("mlp", {"data": r}) for r in reqs]
            got = np.concatenate([f.result(120)[0].asnumpy() for f in futs])
            batches = srv.stats()["mlp"]["batches"]
            launches = fc_relu.launches
        finally:
            srv.shutdown(drain=True)
        worst = op_ratio(got, want, SERVE_TRAIN_TOL)
        check(worst <= 1.0, f"16b: served answers vs Module.predict at "
              f"{worst:.3f} of rtol 1e-4 + 1e-5*max")
        check(launches == 2 * batches, f"16b: K1 launched {launches} times "
              f"for {batches} served batches")
        print(f"serve16 checkpoint dir: newest valid snapshot step {step} "
              f"(a torn step {step + 1000} beside it), loaded parameters "
              f"equal it; {len(reqs)} requests of 1-32 rows in {batches} "
              f"batches vs Module.predict {worst:.3f} of rtol 1e-4 + "
              f"1e-5*max; K1 {launches} launches (2 a batch) [{card}]")
        out.update(k1_launches=launches, batches=batches, worst=worst)
        out["breaker"] = breaker16(mx, card, symbol_file, root, images)
        out["k1_launches"] += out["breaker"]["k1_launches"]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def breaker16_run(mx, ctx, symbol_file, root, x):
    """The JAX scripts of tests/test_resilience.py:467 and :489 on one
    device: two failed batches open the breaker, submit fails fast,
    the probe after the reset window closes it; then two failed
    attempts under RetryPolicy(max_attempts=3) and the third answers.
    Returns (counters, the two answers)."""
    from incubator_mxnet_tpu_torch import resilience
    res, answers = {}, []
    common = dict(symbol_file=symbol_file, checkpoint_dir=root,
                  data_shapes=[("data", (1, 1, 28, 28))], buckets=(1, 2))
    resilience.clear()
    try:
        with mx.serving.ModelServer(max_queue_latency_ms=0.0,
                                    ctx=ctx) as srv:
            srv.load_model("brk", breaker_threshold=2, breaker_reset_s=0.25,
                           **common)
            resilience.inject("serving.execute", "error", n=2)
            fails = 0
            for _ in range(2):
                try:
                    srv.predict("brk", {"data": x})
                except mx.MXNetError as e:
                    fails += "fault-injected" in str(e)
            try:
                srv.submit("brk", {"data": x})
                fast = False
            except mx.MXNetError as e:
                fast = "circuit breaker is open" in str(e)
            s = srv.stats()["brk"]
            res["open"] = (fails, fast, s["breaker_state"],
                           s["breaker_rejects"])
            time.sleep(0.3)
            answers.append(srv.predict("brk", {"data": x})[0].asnumpy())
            s = srv.stats()["brk"]
            res["closed"] = (s["breaker_state"], s["breaker_rejects"],
                             s["responses"], len(resilience.trace()))
        resilience.clear()
        with mx.serving.ModelServer(max_queue_latency_ms=0.0,
                                    ctx=ctx) as srv:
            srv.load_model("rty", retry_policy=resilience.RetryPolicy(
                max_attempts=3, base_delay=0.01, jitter=0.0), **common)
            resilience.inject("serving.execute", "error", n=2)
            answers.append(srv.predict("rty", {"data": x})[0].asnumpy())
            s = srv.stats()["rty"]
            res["retry"] = (s["retry_histogram"], s["breaker_state"],
                            s["responses"])
    finally:
        resilience.clear()
    return res, answers


def breaker16(mx, card, symbol_file, root, images):
    """16c: the breaker and retry scripts on the card against the CPU:
    the counters equal, the answers equal the 16b server's."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    x = images[:1]
    fc_relu.launches = 0
    g_res, g_ans = breaker16_run(mx, mx.gpu(0), symbol_file, root, x)
    launches = fc_relu.launches
    c_res, c_ans = breaker16_run(mx, mx.cpu(), symbol_file, root, x)
    check(g_res == c_res, f"16c: the card's counters {g_res} differ from "
          f"the CPU's {c_res}")
    check(g_res["open"] == (2, True, "open", 1) and
          g_res["closed"] == ("closed", 1, 1, 2) and
          g_res["retry"] == ({1: 1, 2: 1}, "closed", 1),
          f"16c: the scripts saw {g_res}")
    with mx.serving.ModelServer(ctx=mx.gpu(0)) as srv:
        srv.load_model("mlp", symbol_file=symbol_file, checkpoint_dir=root,
                       data_shapes=[("data", (1, 1, 28, 28))], buckets=(1,))
        ref = srv.predict("mlp", {"data": x})[0].asnumpy()
    same = all(np.array_equal(a, ref) for a in g_ans)
    cpu = max(op_ratio(a, ref, SERVE_TRAIN_TOL) for a in c_ans)
    check(same and cpu <= 1.0, f"16c: answers equal 16b's {same}, the CPU's "
          f"at {cpu:.3f} of the tolerance")
    print(f"breaker16 on the card: 2 failed batches opened the breaker, "
          f"submit failed fast (breaker_rejects {g_res['open'][3]}), the "
          f"probe after 0.25 s closed it; RetryPolicy(max_attempts=3) "
          f"histogram {g_res['retry'][0]}; counters equal the CPU's; "
          f"answers equal 16b's bit for bit, the CPU's at {cpu:.3f} of rtol "
          f"1e-4 + 1e-5*max; K1 {launches} launches [{card}]")
    return {"k1_launches": launches, "counters": g_res}


def c16_input(shape):
    """The C program's input: element i is ((i * 7919) % 1000) / 1000."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    return ((i * 7919) % 1000).astype(np.float32).reshape(shape) * \
        np.float32(0.001)


def c16(mx, card, workdir):
    """16d: the C predict ABI on the card: the shim built from the
    checkout, a C program compiled with g++ against it, run with dev_type
    2 on the TPU_PALLAS-partitioned mlp at batch 32, against an
    in-process predictor; dev_type 1 against the card; dev_type 7
    refused."""
    from incubator_mxnet_tpu_torch import c_predict, native
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    t0 = time.perf_counter()
    k1_held(C16_BATCH, "16d")
    lib = native.build_predict()
    tmp = tempfile.mkdtemp(dir=workdir, prefix="c16-")
    try:
        exe = os.path.join(tmp, "main")
        proc = subprocess.run(["g++", "-x", "c++",
                               str(native.PREDICT_EXAMPLE), "-o", exe,
                               *native.predict_flags(lib)],
                              capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0, f"16d: g++ failed: {proc.stderr[-2000:]}")
        build_s = time.perf_counter() - t0
        sym = mx.subgraph.partition_graph(mlp_symbol(mx), "TPU_PALLAS")
        rng = np.random.RandomState(SEED + 16)
        shapes, _, _ = sym.infer_shape(data=(C16_BATCH, 1, 28, 28))
        params = {n: mx.nd.array(rng.normal(0, 0.05, s).astype("f4"),
                                 ctx=mx.cpu())
                  for n, s in zip(sym.list_arguments(), shapes)
                  if n not in ("data", "softmax_label")}
        prefix = os.path.join(tmp, "mlp")
        mx.model.save_checkpoint(prefix, 0, sym, params, {})
        here = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=here)
        dims = [str(C16_BATCH), "1", "28", "28"]
        runs = {}
        procs = {dt: subprocess.Popen(
            [exe, prefix + "-symbol.json", prefix + "-0000.params", str(dt),
             *dims], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env, cwd=tmp) for dt in (2, 1, 7)}
        try:
            for dt, p in procs.items():
                o, e = p.communicate(timeout=600)
                runs[dt] = (p.returncode, o, e)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for dt in (2, 1):
            rc, o, e = runs[dt]
            check(rc == 0, f"16d: the C program (dev_type {dt}) exit {rc}: "
                  f"{o[-500:]} {e[-2000:]}")
        rc7, o7, _ = runs[7]
        check(rc7 == 3 and "dev_type 7" in o7, f"16d: dev_type 7 exit {rc7}, "
              f"{o7[-300:]}")

        def parsed(o):
            lines = o.strip().splitlines()
            check(lines[0] == f"shape {C16_BATCH}x10", f"16d: {lines[0]}")
            return np.array([float(v) for v in lines[1].split()],
                            np.float32).reshape(C16_BATCH, 10)
        g_c, c_c = parsed(runs[2][1]), parsed(runs[1][1])
        with open(prefix + "-symbol.json") as f:
            js = f.read()
        with open(prefix + "-0000.params", "rb") as f:
            pb = f.read()
        pred = c_predict.create(js, pb, 2, 0, ["data"],
                                [(C16_BATCH, 1, 28, 28)])
        pred.set_input("data", c16_input((C16_BATCH, 1, 28, 28)).ravel())
        fc_relu.launches = 0
        pred.forward()
        launches = fc_relu.launches
        inproc = np.frombuffer(pred.output(0), np.float32).reshape(
            C16_BATCH, 10)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    exact = lstm_ratio({"out": g_c}, {"out": inproc},
                       (C16_EXACT, 0.0))[0]
    cpu = op_ratio(c_c, g_c, SERVE_TRAIN_TOL)
    check(exact <= 1.0, f"16d: the C program vs in process at {exact:.3f} "
          "of rtol 1e-6")
    check(launches == 2, f"16d: K1 launched {launches} times in one forward")
    check(cpu <= 1.0, f"16d: dev_type 1 vs 2 at {cpu:.3f} of rtol 1e-4 + "
          "1e-5*max")
    print(f"c16 C predict ABI: shim + C program built in {build_s:.1f} s "
          f"({os.path.relpath(lib, here)}); dev_type 2, mlp (TPU_PALLAS) "
          f"at batch {C16_BATCH}: the C program's outputs vs an in-process "
          f"predictor {exact:.3f} of rtol 1e-6; K1 {launches} launches a "
          f"forward; dev_type 1 vs 2 {cpu:.3f} of rtol 1e-4 + 1e-5*max; "
          f"dev_type 7 refused ({o7.strip()[:80]!r}) [{card}]")
    return {"k1_launches": launches, "build_s": build_s}


def resume16_child(mode, ckpt_dir, out_path):
    """Phase 16e's child process (`python -c`): config #4 at its
    published widths (LSTM_CFG) on RESUME16's corpus and buckets through
    BucketingModule.fit on the card under
    torch.use_deterministic_algorithms(True), momentum 0.9.  `mode`:
    "full", "kill" (SIGKILL itself after batch kill_after), "term"
    (waits at batch term_after for SIGTERM: a final snapshot and exit
    143), "resume".  Prints "STEP n"; writes the sha256 of every bucket's
    parameters, every momentum and the update count to `out_path`."""
    import hashlib
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.compat import weights
    r = RESUME16
    cfg = dict(LSTM_CFG, sentences=r["sentences"], buckets=r["buckets"])
    it = lstm_iter(mx, lstm_corpus(cfg), cfg)
    mx.random.seed(SEED)
    mod = mx.mod.BucketingModule(lstm_sym_gen(mx, cfg),
                                 default_bucket_key=max(cfg["buckets"]),
                                 context=mx.gpu(0))
    done = {"n": 0}

    def cb(p):
        done["n"] += 1
        step = p.locals["gstep"] + 1
        print(f"STEP {step}", flush=True)
        if mode == "kill" and step == r["kill_after"]:
            torch.cuda.synchronize()
            os.kill(os.getpid(), signal.SIGKILL)
        if mode == "term" and step == r["term_after"]:
            mgr = p.locals["ckpt_mgr"]
            deadline = time.time() + 120
            while not mgr.preempt_requested and time.time() < deadline:
                time.sleep(0.02)

    mod.fit(it, num_epoch=r["epochs"], optimizer="sgd",
            optimizer_params=dict(LSTM_OPT, momentum=0.9),
            eval_metric=mx.metric.Perplexity(0), initializer=lstm_init(mx),
            checkpoint_dir=None if mode == "full" else ckpt_dir,
            checkpoint_period=r["period"], checkpoint_keep_last=2,
            resume=mode == "resume", batch_end_callback=cb, kvstore=None)
    default = mod._buckets[max(cfg["buckets"])]
    names = default._exec_group.param_names

    def digest(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
    out = {"param:" + k: digest(v) for k, v in
           weights.bucketing_params_to_numpy(mod).items()}
    out.update({"momentum:" + names[i]: digest(s.asnumpy())
                for i, s in default._updater.states.items()})
    out["num_update"] = default._optimizer.num_update
    out["batches_run"] = done["n"]
    out["buckets"] = sorted(mod._buckets)
    with open(out_path, "w") as f:
        json.dump(out, f)
    return 0


def resume16(mx, card, workdir):
    """16e: BucketingModule.fit(checkpoint_dir=) on config #4 across
    processes, as 10c: uninterrupted; SIGKILL after batch kill_after;
    SIGTERM at batch term_after (exit 143, a final snapshot marked
    preempted); both resumed; every parameter, begin state and momentum
    sha256-equal to the uninterrupted fit's."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    r = RESUME16
    env = dict(os.environ, **LM_RESUME_ENV)
    root = tempfile.mkdtemp(dir=workdir, prefix="resume16-")
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys, chip_smoke; "
            "sys.exit(chip_smoke.resume16_child(*sys.argv[1:]))")
    procs = {}

    def spawn(name, mode, d):
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", code, mode, d,
             os.path.join(root, name + ".json")], cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def finish(name, timeout=600):
        out, err = procs[name].communicate(timeout=timeout)
        return procs[name].returncode, out, err

    kill_dir, term_dir = os.path.join(root, "kill"), os.path.join(root,
                                                                  "term")
    t0 = time.perf_counter()
    try:
        spawn("full", "full", "-")
        spawn("kill", "kill", kill_dir)
        spawn("term", "term", term_dir)
        term, seen = procs["term"], []
        for line in term.stdout:
            seen.append(line)
            if line.strip() == f"STEP {r['term_after']}":
                term.send_signal(signal.SIGTERM)
                break
        codes = {name: finish(name) for name in ("full", "kill", "term")}
        codes["term"] = (codes["term"][0], "".join(seen) + codes["term"][1],
                         codes["term"][2])
        for name, want in (("full", 0), ("kill", -signal.SIGKILL),
                           ("term", 143)):
            rc, out, err = codes[name]
            check(rc == want, f"16e {name}: exit {rc}, expected {want}: "
                  f"{out[-800:]} {err[-2000:]}")
        last_term = ckpt.load(ckpt.latest(term_dir))
        check(last_term.meta.get("preempted") is True and
              last_term.step == r["term_after"],
              f"16e: SIGTERM's snapshot is step {last_term.step}, meta "
              f"{last_term.meta}")
        kill_step = ckpt.load(ckpt.latest(kill_dir)).step
        spawn("resume_kill", "resume", kill_dir)
        spawn("resume_term", "resume", term_dir)
        for name in ("resume_kill", "resume_term"):
            rc, out, err = finish(name)
            check(rc == 0, f"16e {name}: exit {rc}: {err[-2000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    res = {}
    for name in ("full", "resume_kill", "resume_term"):
        with open(os.path.join(root, name + ".json")) as f:
            res[name] = json.load(f)
    shutil.rmtree(root, ignore_errors=True)
    arrays = [k for k in res["full"] if ":" in k]
    for name in ("resume_kill", "resume_term"):
        off = [k for k in arrays if res[name].get(k) != res["full"][k]]
        check(not off and res[name]["num_update"] ==
              res["full"]["num_update"], f"16e {name}: {len(off)} of "
              f"{len(arrays)} arrays differ from the uninterrupted fit "
              f"({off[:4]})")
    begin = sum("begin_state" in k for k in arrays if k.startswith("param:"))
    cfg = LSTM_CFG
    print(f"resume16 config #4 ({cfg['layers']}x{cfg['hidden']} LSTM, vocab "
          f"{cfg['vocab']}, batch {cfg['batch']}, buckets "
          f"{'/'.join(map(str, r['buckets']))}, {r['sentences']} sentences, "
          f"{res['full']['num_update']} batches over {r['epochs']} epochs) "
          f"through BucketingModule.fit(checkpoint_dir=): SIGKILL after "
          f"batch {r['kill_after']} (resumed from step {kill_step}) and "
          f"SIGTERM at batch {r['term_after']} (exit 143, preempted "
          f"snapshot) both resumed sha256-equal to the uninterrupted fit "
          f"over {len(arrays)} arrays ({begin} begin states, the momenta) "
          f"in {time.perf_counter() - t0:.1f} s [{card}]")
    return {"arrays": len(arrays), "batches": res["full"]["num_update"]}


def state16_net(mx):
    """An RNN-like step with a carried state input: tanh(W x + U s)."""
    s = mx.sym
    h = s.FullyConnected(s.Variable("data"), num_hidden=200, name="wx") + \
        s.FullyConnected(s.Variable("state", shape=(32, 200)),
                         num_hidden=200, no_bias=True, name="us")
    out = s.FullyConnected(s.tanh(h), num_hidden=10, name="out")
    return s.SoftmaxOutput(out, name="softmax")


def state16_step(mx, ctx, x, y, state):
    mod = mx.mod.Module(state16_net(mx), state_names=["state"], context=ctx)
    mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
    mx.random.seed(SEED)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer(optimizer_params={"learning_rate": TRAIN_LR,
                                         "momentum": TRAIN_MOMENTUM})
    check(mod._fused_step is None and "state" not in mod._param_names,
          "16e: a state input became a parameter or took the fused step")
    mod.set_states(states=[state])
    batch = mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                            [mx.nd.array(y, ctx=mx.cpu())])
    mod.fit_step(batch, mx.metric.create("acc"))
    names = mod._exec_group.param_names
    return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            {names[i]: s.asnumpy() for i, s in mod._updater.states.items()},
            mod.get_states()[0].asnumpy())


def state16(mx, card):
    """16e: a Module(state_names=["state"]) step on the card against the
    CPU at 11a's gates; the state comes back as it was written."""
    rng = np.random.RandomState(SEED + 160)
    x = rng.normal(0, 1, (32, 200)).astype("f4")
    y = rng.randint(0, 10, 32).astype("f4")
    state = rng.normal(0, 1, (32, 200)).astype("f4")
    g = state16_step(mx, mx.gpu(0), x, y, state)
    c = state16_step(mx, mx.cpu(), x, y, state)
    worst = max(lstm_ratio(g[0], c[0])[0], lstm_ratio(g[1], c[1])[0])
    check(worst <= 1.0 and np.array_equal(g[2], state),
          f"16e: state_names step card vs CPU at {worst:.3f}")
    print(f"state16 Module(state_names=['state']): one step on the card vs "
          f"the CPU, parameters and momenta {worst:.3f} of rtol 1e-3 + "
          f"1e-4*max; the state bound, untrained, as written [{card}]")
    return worst


def utils16(mx, card):
    """16f: test_utils on the card: check_consistency over [cpu(0),
    gpu(0)] on the partitioned mlp (K1 forward) and on lenet at the
    default per-dtype tolerances; check_numeric_gradient in float64 for
    FullyConnected and Convolution, and its refusal of SoftmaxOutput
    (whose implicit gradient is not its output's) as on the CPU, with
    SoftmaxOutput's gradient held by check_symbolic_backward."""
    from incubator_mxnet_tpu_torch import test_utils as tu
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    batch = UTILS16_BATCH
    k1_held(batch, "16f")
    labels = {"softmax_label": np.arange(batch) % 10}
    shapes = {"data": (batch, 1, 28, 28)}
    ctx_list = [dict(ctx=mx.cpu(0), **shapes), dict(ctx=mx.gpu(0), **shapes)]
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    try:
        fc_relu.launches = 0
        tu.check_consistency(mlp_symbol(mx), ctx_list, scale=0.1,
                             arg_params=labels)
        launches = fc_relu.launches
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
    check(launches == 2, f"16f: K1 launched {launches} times in the card's "
          "check_consistency forward")
    lenet_list = [dict(ctx=mx.cpu(0), data=(4, 1, 28, 28)),
                  dict(ctx=mx.gpu(0), data=(4, 1, 28, 28))]
    tu.check_consistency(lenet_symbol(mx), lenet_list, scale=0.1,
                         arg_params={"softmax_label": np.arange(4)})
    rng = np.random.RandomState(SEED + 161)
    d = mx.sym.Variable("data")
    m, k, n = GRAD16["fc"]
    tu.check_numeric_gradient(
        mx.sym.FullyConnected(d, num_hidden=n, name="fc"),
        {"data": rng.randn(m, k), "fc_weight": rng.randn(n, k),
         "fc_bias": rng.randn(n)}, ctx=mx.gpu(0))
    b, c, h, w, f, kk = GRAD16["conv"]
    tu.check_numeric_gradient(
        mx.sym.Convolution(d, kernel=(kk, kk), num_filter=f, name="cv"),
        {"data": rng.randn(b, c, h, w), "cv_weight": rng.randn(f, c, kk, kk),
         "cv_bias": rng.randn(f)}, ctx=mx.gpu(0))
    sm = mx.sym.SoftmaxOutput(d, mx.sym.Variable("softmax_label"), name="sm")
    z, lab = rng.randn(3, 4), np.array([0.0, 1.0, 3.0])
    verdicts = []
    for ctx in (mx.gpu(0), mx.cpu()):
        try:
            tu.check_numeric_gradient(sm, {"data": z, "softmax_label": lab},
                                      grad_nodes=["data"], ctx=ctx)
            verdicts.append("passed")
        except AssertionError:
            verdicts.append("rejected")
    check(verdicts == ["rejected", "rejected"], f"16f: SoftmaxOutput's "
          f"numeric check {verdicts} on (card, CPU)")
    p = np.exp(z - z.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    tu.check_symbolic_backward(sm, {"data": z, "softmax_label": lab}, None,
                               {"data": p - np.eye(4)[lab.astype(int)]},
                               rtol=1e-5, atol=1e-6, ctx=mx.gpu(0))
    print(f"utils16 test_utils on the card: check_consistency [cpu(0), "
          f"gpu(0)] on the mlp (TPU_PALLAS, K1 {launches} launches) and "
          f"lenet at the default tolerances; check_numeric_gradient float64 "
          f"FullyConnected {GRAD16['fc']} and Convolution {GRAD16['conv']} "
          f"passed, SoftmaxOutput rejected on both devices, its gradient "
          f"p - onehot held by check_symbolic_backward [{card}]")
    return {"k1_launches": launches}


def api_phase(card, workdir):
    """Phase 16; returns K1's launches on each of its new paths.  K2 and
    K3 must not run."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    for wrapper in (flash_fwd, flash_fwd_stream):
        wrapper.launches = 0
    out, times = {}, {}
    old = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    try:
        for key, fn in (("16a", lambda: ff16(mx, card, workdir)),
                        ("16b", lambda: serve16(mx, card, workdir)),
                        ("16d", lambda: c16(mx, card, workdir))):
            t0 = time.perf_counter()
            out[key] = fn()
            times[key] = time.perf_counter() - t0
            print(f"phase {key}: {times[key]:.1f} s")
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        if old is not None:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    for key, fn in (("16e", lambda: (resume16(mx, card, workdir),
                                     state16(mx, card))),
                    ("16f", lambda: utils16(mx, card))):
        t0 = time.perf_counter()
        out[key] = fn()
        times[key] = time.perf_counter() - t0
        print(f"phase {key}: {time.perf_counter() - t0:.1f} s")
    check([flash_fwd.launches, flash_fwd_stream.launches] == [0, 0],
          "phase 16: K2/K3 ran")
    out["times"] = times
    out["k1"] = {"feedforward": out["16a"]["k1_launches"],
                 "checkpoint_serving": out["16b"]["k1_launches"],
                 "c_predict": out["16d"]["k1_launches"],
                 "check_consistency": out["16f"]["k1_launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 17: gluon's remaining layers and the model zoo (slice 15) ---------

# AlexNet (model_zoo/vision/alexnet.py) at 224x224: fc6 is 256 x 6 x 6 ->
# 4096; its fc7 is VGG-16's (4096 -> 4096).  Both feed a ReLU, so under
# TPU_PALLAS each is one K1 node.
ALEX_FC6 = (9216, 4096)
# the JSON line's AlexNet keys: fc6 at the lane's batch, fp32 and bf16
ALEX_REP = (128, 9216, 4096, F32)
ALEX_REP_BF16 = (128, 9216, 4096, BF16)
ALEX_PREFIX = "alexnet_"        # a fixed prefix: every instance, one name
ALEX_PARITY = (8, 2)            # 17a: (batch, steps), fp32, card vs CPU
# 17b: phase 7's BASELINE lane (bf16 with fp32 master weights, batch 128,
# Xavier) on AlexNet with its Dropout(0.5)
ALEX_LANE = dict(batch=128, warm=4, timed=16)
# phase 17's SGD, AlexNet's own (Krizhevsky et al. 2012, section 5: lr
# 0.01, momentum 0.9, weight decay 5e-4): at phase 7's lr 0.05 AlexNet,
# without BatchNorm, reached a loss of inf after one step, and SqueezeNet
# went from 1.4 to 814 (runs on the CPU at 10 classes; 18 at lr 0.01)
OPT17 = {"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4}
ALEX_SERVE_SIZES = (1, 2, 3, 5, 12, 27, 32)   # 17c: buckets 1, 2, 4, .. 32
ALEX_IMPORT_BATCH = 8           # 17c: SymbolBlock.imports vs the block
DROP_RATE, DROP_BAND = 0.5, 0.02    # 17a: kept share within 0.5 +- 0.02
# 17d: the other families at full width (1000 classes; Inception v3 at
# 299x299, as its AvgPool2D(8) needs), each run hybridized through a
# gluon Trainer
ZOO17 = (("densenet121", 224), ("inceptionv3", 299), ("mobilenet1.0", 224),
         ("mobilenetv2_1.0", 224), ("squeezenet1.0", 224),
         ("squeezenet1.1", 224))
ZOO17_PARITY = (2, 2)           # 17d: (batch, steps), float64, card vs CPU
ZOO17_LANE = dict(batch=32, warm=2, timed=3)   # 17d: fp32 on the card
ZOO17_PREFIX = "zoo_"
# 17e: a block on the card against the CPU in fp32 (TF32 off): products
# (cuDNN, cuBLAS) and sums in other orders, as phase 15's products
BLOCK17_TOL = (1e-4, 1e-5)
# SymbolBlock.imports against the block on the card: the same graph, the
# same device and kernels, so only a reordered sum may differ
IMPORT17_TOL = (1e-6, 1e-7)


def set_dropout(block, rate):
    """Every Dropout block under `block` to `rate`; returns how many.
    The parities set 0: the card's and the CPU's generators draw
    different masks."""
    n = 0
    if type(block).__name__ == "Dropout":
        block._rate = rate
        n = 1
    return n + sum(set_dropout(c, rate) for c in block._children.values())


def alex_net(mx, rate=DROP_RATE):
    """gluon alexnet(CLASSES) under ALEX_PREFIX with its two Dropout
    layers at `rate`."""
    net = mx.gluon.model_zoo.vision.alexnet(classes=CLASSES,
                                            prefix=ALEX_PREFIX)
    check(set_dropout(net, rate) == 2, "alexnet: not two Dropout layers")
    return net


def alex_symbol(mx, rate=DROP_RATE):
    """(net, AlexNet composed on Variable("data") + SoftmaxOutput), as
    `resnet_symbol` composes ResNet-50."""
    net = alex_net(mx, rate)
    return net, mx.sym.SoftmaxOutput(net(mx.sym.Variable("data")),
                                     name="softmax")


def alex_k1_held(m, dtype, where):
    """Fail unless phase 3 held K1 against fc_relu_ref at AlexNet's fc6
    and fc7 with M = m in `dtype`."""
    held = {(mm, k, n, dt) for k, n in VGG_FC_SHAPES + (ALEX_FC6,)
            for mm in K1_ROWS for dt in (F32, BF16, F16)}
    check((m,) + ALEX_FC6 + (dtype,) in held
          and (m, 4096, 4096, dtype) in held,
          f"{where}: AlexNet's K1 shapes at M={m} {dtype} were not held "
          "against fc_relu_ref in phase 3")


# AlexNet's layers in order, by their parameters' prefixes (fc6 and fc7
# are dense0 and dense1; dense2, the classifier, feeds no ReLU)
ALEX_LAYERS = tuple(f"{ALEX_PREFIX}conv2d{i}_" for i in range(5)) + \
    (f"{ALEX_PREFIX}dense0_", f"{ALEX_PREFIX}dense1_")


def alex_routes(params, x, ctx):
    """{layer: routes} of AlexNet at these parameters and images on `ctx`:
    which units each ReLU passes, and which element wins each window of
    the max-pool after it, from the torch calls the port's Convolution,
    relu and Pooling make and, for fc6 and fc7, from K1 on the card and
    its plain version on the CPU (the calls the path makes)."""
    import torch.nn.functional as F
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import (
        fc_relu, fc_relu_ref)
    dev = ctx.torch_device
    p = {n: torch.from_numpy(v).to(dev) for n, v in params.items()}
    h = torch.from_numpy(x).to(dev)
    routes = {}
    for i, (stride, pad) in enumerate(((4, 2), (1, 2), (1, 1), (1, 1),
                                       (1, 1))):
        layer = ALEX_LAYERS[i]
        h = F.relu(F.conv2d(h, p[layer + "weight"], p[layer + "bias"],
                            stride, pad))
        routes[layer] = [(h > 0).cpu()]
        if i in (0, 1, 4):
            h, idx = F.max_pool2d(h, 3, 2, return_indices=True)
            routes[layer].append(idx.cpu())
    h = h.flatten(1)
    fc = fc_relu if dev.type == "cuda" else fc_relu_ref
    for layer in ALEX_LAYERS[5:]:
        h = fc(h.contiguous(), p[layer + "weight"], p[layer + "bias"])
        routes[layer] = [(h > 0).cpu()]
    return routes


def alex_flips(mx, cpu_params, gpu_params, x):
    """{layer: units or windows routed differently on the CPU at
    `cpu_params` and on the card at `gpu_params`}, the layers with any."""
    cpu = alex_routes(cpu_params, x, mx.cpu())
    gpu = alex_routes(gpu_params, x, mx.gpu(0))
    flips = {layer: sum(int((a != b).sum())
                        for a, b in zip(cpu[layer], gpu[layer]))
             for layer in ALEX_LAYERS}
    return {k: v for k, v in flips.items() if v}


def alex_excused(flips):
    """The layers whose gradients a flip reroutes: every layer up to the
    deepest one with a flip (the backward passes through it)."""
    if not flips:
        return ()
    deepest = max(ALEX_LAYERS.index(k) for k in flips)
    return ALEX_LAYERS[:deepest + 1]


def alex_dropout_check(mx, values, x, card):
    """One train forward of the gluon AlexNet at p = 0.5 on the card,
    forward hooks on its two Dropout blocks: among the units the ReLU
    left non-zero, the kept share within 0.5 +- DROP_BAND and each kept
    value exactly twice its input."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy)
    net = alex_net(mx, DROP_RATE)
    net.initialize(ctx=mx.gpu(0))
    block_params_from_numpy(net, values, ctx=mx.gpu(0))
    seen = []
    for b in net.features:
        if type(b).__name__ == "Dropout":
            b.register_forward_hook(
                lambda blk, inp, out: seen.append(
                    (inp[0].asnumpy(), out.asnumpy())))
    with mx.autograd.train_mode():
        net(mx.nd.array(x, ctx=mx.gpu(0)))
    check(len(seen) == 2, f"dropout hooks fired {len(seen)} times, want 2")
    for k, (inp, out) in enumerate(seen):
        live = inp != 0
        kept = out[live] != 0
        share = float(kept.mean())
        scale = out[live][kept] / inp[live][kept]
        ok = abs(share - 0.5) <= DROP_BAND and bool(
            np.allclose(scale, 2.0, rtol=1e-6, atol=0))
        print(f"17a dropout {k}: p = {DROP_RATE} train forward on the card: "
              f"{int(live.sum())} live units, kept share {share:.4f} (0.5 "
              f"+- {DROP_BAND}), kept values x {scale.min():.6f}.."
              f"{scale.max():.6f} (2) {'ok' if ok else 'FAIL'} [{card}]")
        check(ok, "alexnet: Dropout(0.5) kept share or scale is wrong")


def alex_parity(mx, card):
    """17a: ALEX_PARITY fused Module.fit steps of AlexNet (Dropout at 0,
    OPT17) under TPU_PALLAS, fp32 with TF32 off, the card against the
    CPU from the same Xavier parameters and batches (`resnet_steps`):
    every step's loss within rtol and the parameters after every step
    within PARITY_TOL; then each card step from the CPU's state,
    parameters and momenta within PARITY_TOL.  A ReLU unit whose input
    lies within fp32 rounding of 0, or a max-pool window whose top two
    do, may be routed one way on the CPU and the other on the card; the
    gradient of every layer up to it then moves by that unit's share,
    not by rounding: at such a step those layers are printed, not held
    (phase 6's rule, `alex_flips`).  Along the free-running steps the
    same holds of the card's state against the CPU's: at the first step
    with a flip the layers up to it are excused, and the states after it
    are printed, not held, since every layer then steps from other
    activations (phase 6 holds the free-running parameters only when
    nothing flipped on the way).  Then the Dropout(0.5) train forward
    (`alex_dropout_check`)."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    batch, steps = ALEX_PARITY
    alex_k1_held(batch, F32, "17a")
    _, sym = alex_symbol(mx, 0.0)
    rng = np.random.RandomState(SEED + 17)
    batches = [mx.io.DataBatch(
        [mx.nd.array(rng.rand(batch, *IMAGE).astype("f4"), ctx=mx.cpu())],
        [mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"),
                     ctx=mx.cpu())]) for _ in range(steps)]
    xs = [b.data[0].asnumpy() for b in batches]
    cpu_loss, cpu = resnet_steps(mx, sym, mx.cpu(), batches, "float32",
                                 batch=batch, opt=OPT17)
    fc_relu.launches = 0
    gpu_loss, gpu = resnet_steps(mx, sym, mx.gpu(0), batches, "float32",
                                 batch=batch, opt=OPT17)
    launches = fc_relu.launches
    _, forced = resnet_steps(mx, sym, mx.gpu(0), batches, "float32",
                             teacher=cpu, batch=batch, opt=OPT17)
    check(launches == 2 * steps, f"17a: K1 launched {launches} times in "
          f"{steps} card steps, want 2 a step")
    loss_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_loss, cpu_loss))
    free, free_flips, loose = (0.0, "none"), [], (0.0, "none")
    for k, x in enumerate(xs):
        f = alex_flips(mx, cpu[k][0], gpu[k][0], x)
        free = max(free, param_ratio(gpu[k + 1][0], cpu[k + 1][0],
                                     alex_excused(f)))
        if f:
            free_flips.append(f"step {k + 1}: {f}")
            loose = max(param_ratio(g[0], c[0])
                        for g, c in zip(gpu[k + 1:], cpu[k + 1:]))
            break
    held, excused, flips = (0.0, "none"), (0.0, "none"), []
    for k, x in enumerate(xs):
        f = alex_flips(mx, cpu[k][0], cpu[k][0], x)
        skip = alex_excused(f)
        after, ref = forced[k + 1], cpu[k + 1]
        held = max(held, param_ratio(after[0], ref[0], skip),
                   param_ratio(after[1], ref[1], skip))
        if f:
            flips.append(f"step {k + 1}: {f}")
            excused = max(excused, param_ratio(after[0], ref[0]),
                          param_ratio(after[1], ref[1]))
    ok = loss_err <= PARITY_TOL[0] and free[0] <= 1 and held[0] <= 1
    print(f"17a alexnet parity fp32: {steps} fused Module.fit steps at batch "
          f"{batch}, {IMAGE[1]}x{IMAGE[2]}, Dropout 0, card vs CPU: loss "
          f"{' '.join(f'{v:.5f}' for v in gpu_loss)}; max relative loss err "
          f"{loss_err:.2e} (rtol {PARITY_TOL[0]:g}); parameters after each "
          f"step at {free[0]:.3f} of the tolerance (worst {free[1]}"
          f"{'; the flip below excused' if free_flips else ''}); each "
          f"step from the CPU's state: parameters and momenta at "
          f"{held[0]:.3f} of it (worst {held[1]}) (rtol {PARITY_TOL[0]:g}, "
          f"atol {PARITY_TOL[1]:g}*max|array|); K1 {launches} launches "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    note = f"; the layers up to the deepest flip at those steps at " \
        f"{excused[0]:.3f} of the tolerance (worst {excused[1]}), not held" \
        if flips else ""
    print(f"17a alexnet ReLU units and max-pool windows routed differently "
          f"by the CPU and the card from the CPU's state: "
          f"{'; '.join(flips) or 'none'}{note}; along the free-running "
          f"steps: {'; '.join(free_flips) or 'none'}"
          + (f" (from it on every layer at {loose[0]:.3f} of the tolerance "
             f"(worst {loose[1]}), not held)" if free_flips else ""))
    check(ok, "17a: the card's AlexNet steps disagree with the CPU's")
    alex_dropout_check(mx, cpu[0][0], xs[0], card)
    return {"worst": max(held[0], loss_err / PARITY_TOL[0]),
            "flips": len(flips)}


def alex_lane(mx, card):
    """17b: `resnet_lane` (phase 7's lane through the public Module.fit
    on one resident batch) on AlexNet with Dropout(0.5) and OPT17,
    bf16 with fp32 master weights at ALEX_LANE's batch, K1's count set
    to 0 just before
    the fit and read just after (2 a train forward); then one warm step
    under torch.profiler with K1 as a kernel class of its own."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    batch, warm, timed = (ALEX_LANE[k] for k in ("batch", "warm", "timed"))
    alex_k1_held(batch, BF16, "17b")
    _, sym = alex_symbol(mx, DROP_RATE)
    fc_relu.launches = 0
    mod, out = resnet_lane(mx, sym, "bfloat16", batch, warm, timed, card,
                           PEAK_FLOPS[BF16], label="alexnet", opt=OPT17)
    launches = fc_relu.launches
    steps = warm + timed
    kdt = mod._exec_group.execs[0].arg_dict[f"{ALEX_PREFIX}dense0_weight"] \
        .data.dtype
    print(f"17b alexnet lane: K1 {launches} launches over {steps} train "
          f"forwards (2 each: fc6 at ({batch}, {ALEX_FC6[0]} -> "
          f"{ALEX_FC6[1]}), fc7 at ({batch}, 4096 -> 4096)), in "
          f"{str(kdt)[6:]} [{card}]")
    check(launches == 2 * steps, f"17b: K1 launched {launches} times, want "
          f"{2 * steps}")
    it = resident_iter(mx, batch, "bfloat16", 1)
    one = next(it)
    metric = mx.metric.create("acc")
    classes = (("K1 (fc_relu)", K1_KERNELS),) + KERNEL_CLASSES
    # a session can record only part of a step's kernels (147 of 197 once
    # on an H100, K1's among those lost): up to 3 sessions until K1 shows
    before = fc_relu.launches
    for tries in range(1, 4):
        prof = profile_one_step(lambda: mod.fit_step(one, metric), card,
                                "17b alexnet profile", batch,
                                classes=classes)
        k1_ms = prof["by_class"].get("K1 (fc_relu)", 0.0)
        if k1_ms > 0:
            break
    moved = fc_relu.launches - before
    out["k1_share"] = k1_ms / prof["device_ms"] if k1_ms else None
    share = f"{out['k1_share']:.4f} of the step's device time" if k1_ms \
        else "not recorded"
    print(f"17b alexnet profile: K1 {share} ({tries} profiler sessions; "
          f"K1 launched {moved} times in the profiled calls) [{card}]")
    if not k1_ms:
        # the sessions kept the step's other kernels and lost K1's: K1's
        # device time at the step's two shapes (`device_ms`, names
        # K1_KERNELS; CUDA events if the profiler loses them again) over
        # the step's device time with them added
        g = torch.Generator(device="cuda").manual_seed(SEED)
        calls = []
        for k, n in ((ALEX_FC6[0], ALEX_FC6[1]), (4096, 4096)):
            x, w, b = (torch.randn(shape, generator=g, device="cuda",
                                   dtype=BF16)
                       for shape in ((batch, k), (n, k), (n,)))
            calls.append((lambda x=x, w=w, b=b: fc_relu(x, w, b),
                          k1_per_call(x, w, None)))
        k1_ms = sum(device_ms(c, names=K1_KERNELS, per_call=kernels)
                    for c, kernels in calls)
        out["k1_share"] = k1_ms / (prof["device_ms"] + k1_ms)
        out["k1_share_estimated"] = True
        print(f"17b alexnet profile: K1 estimated at {out['k1_share']:.4f} "
              f"of the step's device time ({k1_ms:.4f} ms at fc6 and fc7 "
              f"timed alone, {prof['device_ms']:.2f} ms of the step's "
              f"other kernels) [{card}]")
    out["profile"] = prof
    out["launches"] = launches
    return mod, out


def alex_serve(mx, mod, card, workdir):
    """17c: the trained lane's parameters (widened to fp32) into the
    gluon AlexNet, hybridized and exported; the export partitioned by
    TPU_PALLAS (a served model never partitions itself) and served
    through ModelServer at buckets 1-32 on the card, K1's count set to 0
    just before the load and read after the last answer (2 per warm-up
    and per batch); every answer held to Module.predict of the exported
    pair (SERVE_TOL: cuDNN picks other fp32 algorithms for the padded
    bucket than for predict's batch); then SymbolBlock.imports of the
    export, by default on current_context(), the card, against the
    block's forward (IMPORT17_TOL)."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    for m in BUCKETS:
        alex_k1_held(m, F32, "17c")
    args, _ = mod.get_params()
    values = {n: v.asnumpy().astype("f4") for n, v in args.items()}
    net = alex_net(mx, DROP_RATE)
    net.initialize(ctx=mx.gpu(0))
    block_params_from_numpy(net, values, ctx=mx.gpu(0))
    net.hybridize()
    rng = np.random.RandomState(SEED + 18)
    x8 = rng.rand(ALEX_IMPORT_BATCH, *IMAGE).astype("f4")
    ref8 = net(mx.nd.array(x8, ctx=mx.gpu(0))).asnumpy()
    reqs = [rng.rand(n, *IMAGE).astype("f4") for n in ALEX_SERVE_SIZES]
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        prefix = os.path.join(tmp, "alexnet")
        net.export(prefix)
        part = mx.subgraph.partition_graph(
            mx.sym.load(prefix + "-symbol.json"), "TPU_PALLAS")
        fused = [n["op"] for n in json.loads(part.tojson())["nodes"]
                 ].count("_sg_pallas_fc_relu")
        check(fused == 2, f"17c: the export partitions to {fused} K1 nodes")
        served = os.path.join(tmp, "alexnet_k1")
        part.save(served + "-symbol.json")
        shutil.copy(prefix + "-0000.params", served + "-0000.params")
        pm = mx.mod.Module.load(prefix, 0, data_names=("data",),
                                label_names=None, context=mx.gpu(0))
        pm.bind([("data", (max(BUCKETS),) + IMAGE)], for_training=False)
        want = [pm.predict(x).asnumpy() for x in reqs]
        srv = mx.serving.ModelServer(max_queue_latency_ms=2.0,
                                     ctx=mx.gpu(0))
        fc_relu.launches = 0
        srv.load_model("alexnet", prefix=served, epoch=0,
                       data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
        got = [srv.predict("alexnet", {"data": x},
                           timeout_ms=600_000)[0].asnumpy() for x in reqs]
        launches = fc_relu.launches
        batches = srv.stats()["alexnet"]["batches"]
        srv.shutdown(drain=True)
        sb = mx.gluon.SymbolBlock.imports(prefix + "-symbol.json", "data",
                                          prefix + "-0000.params")
        ctxs = {str(c) for p in sb.collect_params().values()
                for c in p.list_ctx()}
        imported = sb(mx.nd.array(x8, ctx=mx.gpu(0))).asnumpy()
    expect = 2 * (len(BUCKETS) + batches)
    check(batches == len(reqs) and launches == expect,
          f"17c: {batches} batches for {len(reqs)} lone requests, K1 "
          f"{launches} launches, want {expect}")
    worst = max(op_ratio(g, w, SERVE_TOL) for g, w in zip(got, want))
    shapes_ok = all(g.shape == (len(x), CLASSES) and np.isfinite(g).all()
                    for g, x in zip(got, reqs))
    agree = float(np.mean(np.concatenate([g.argmax(1) == w.argmax(1)
                                          for g, w in zip(got, want)])))
    ok = shapes_ok and worst <= 1
    print(f"17c alexnet serve: export partitioned (2 K1 nodes), "
          f"{len(reqs)} requests of {sum(ALEX_SERVE_SIZES)} images one at "
          f"a time (buckets {BUCKETS}), K1 {launches} launches = 2 x "
          f"({len(BUCKETS)} warm-up + {batches} batches); answers vs "
          f"Module.predict at {worst:.3f} of the tolerance (rtol "
          f"{SERVE_TOL[0]:g}, atol {SERVE_TOL[1]:g}*max|ref|), argmax "
          f"agreement {agree:.4f} {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "17c: served AlexNet answers disagree with Module.predict")
    imp = op_ratio(imported, ref8, IMPORT17_TOL)
    ok = imp <= 1 and ctxs == {str(mx.gpu(0))}
    print(f"17c alexnet SymbolBlock.imports: parameters on {sorted(ctxs)} "
          f"(current_context()), forward at batch {ALEX_IMPORT_BATCH} vs "
          f"the hybridized block at {imp:.3f} of the tolerance (rtol "
          f"{IMPORT17_TOL[0]:g}, atol {IMPORT17_TOL[1]:g}*max|ref|) "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "17c: the imported SymbolBlock disagrees with the block")
    return {"launches": launches, "batches": batches, "worst": worst,
            "import": imp}


def zoo_values(mx, name, side):
    """Xavier(gaussian, in, 2) parameters of `name` (1000 classes, its
    Dropout at 0) under the seed, the deferred shapes finished by one
    predict-mode forward on the CPU, as numpy; every BatchNorm's beta
    drawn from U(-0.1, 0.1).  At beta 0, a channel that a ReLU6 zeroed
    hands the next ReLU6 its BatchNorm's beta, exactly the kink, where a
    rounding's sign on either device decides whether the gradient passes
    (MobileNet v2 at beta 0 on an H100: a beta's momentum 9785x the
    tolerance apart, card vs CPU in float64)."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_to_numpy)
    net = zoo_net(mx, name)
    mx.random.seed(SEED)
    net.initialize(resnet_init(mx), ctx=mx.cpu())
    net(mx.nd.zeros((1, 3, side, side), ctx=mx.cpu()))
    values = block_params_to_numpy(net)
    rng = np.random.RandomState(SEED + 24)
    for k in sorted(values):
        if k.endswith("_beta"):
            values[k] = rng.uniform(-0.1, 0.1, values[k].shape).astype(
                values[k].dtype)
    return values


def zoo_net(mx, name, ctx=None, values=None, dtype="float32"):
    """get_model(name, classes=1000) under ZOO17_PREFIX, every Dropout at
    0; with `values`, initialized from them on `ctx` and cast to
    `dtype`."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy)
    net = mx.gluon.model_zoo.vision.get_model(name, classes=CLASSES,
                                              prefix=ZOO17_PREFIX)
    set_dropout(net, 0.0)
    if values is not None:
        net.initialize(ctx=ctx)
        block_params_from_numpy(net, values, ctx=ctx)
        net.cast(dtype)
    return net


def zoo_steps(mx, name, ctx, values, batches):
    """ZOO17_PARITY steps of the plain loop (record, backward,
    Trainer.step; SGD with OPT17) on the hybridized net in float64 on
    `ctx`: each step's loss and the state after the last."""
    net = zoo_net(mx, name, ctx, values, "float64")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", OPT17)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in batches:
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=ctx, dtype="float64")),
                           mx.nd.array(y, ctx=ctx))
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.asnumpy().mean()))
    return losses, gluon_state(mx, net, trainer)


def zoo_lane(mx, name, side, values, card):
    """One fp32 lane of the hybridized net on the card (TF32 off): the
    plain loop on one resident batch, ZOO17_LANE's warm and timed steps,
    the timed ones between CUDA-synchronised edges; K1's count set to 0
    before and read after (no FC of these nets feeds a ReLU)."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    batch, warm, timed = (ZOO17_LANE[k] for k in ("batch", "warm", "timed"))
    ctx = mx.gpu(0)
    net = zoo_net(mx, name, ctx, values, "float32")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd", OPT17)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    rng = np.random.RandomState(SEED + 19)
    x = mx.nd.array(rng.rand(batch, 3, side, side).astype("f4"), ctx=ctx)
    y = mx.nd.array(rng.randint(0, CLASSES, batch).astype("f4"), ctx=ctx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fc_relu.launches = 0
    losses = []
    for k in range(warm + timed):
        if k == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        with mx.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(batch)
        losses.append(loss.data.detach().mean())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fc_relu.launches
    loss = torch.stack(losses).cpu().numpy()
    ok = bool(np.isfinite(loss).all()) and launches == 0
    out = {"images_s": batch * timed / wall,
           "step_ms": wall / timed * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "k1": launches}
    print(f"17d {name} lane fp32 batch {batch}, {side}x{side}: "
          f"{out['images_s']:.1f} images/s, step {out['step_ms']:.2f} ms "
          f"over {timed} timed steps ({warm} warm), peak "
          f"{out['peak_gib']:.2f} GiB, loss {loss[0]:.4f} -> {loss[-1]:.4f}, "
          f"K1 launches {launches} (none by design) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"17d {name}: loss not finite, or K1 ran")
    return out


def zoo_families(mx, card):
    """17d: each of ZOO17's families, card against CPU in float64 (the
    plain loop, hybridized, ZOO17_PARITY steps from the same Xavier
    values and batches; every step's loss within rtol, the parameters,
    moving statistics and momenta after the last within PARITY_TOL),
    then its fp32 lane on the card."""
    out = {}
    batch, steps = ZOO17_PARITY
    for name, side in ZOO17:
        t0 = time.perf_counter()
        values = zoo_values(mx, name, side)
        rng = np.random.RandomState(SEED + 20)
        batches = [(rng.rand(batch, 3, side, side),
                    rng.randint(0, CLASSES, batch).astype("f4"))
                   for _ in range(steps)]
        cpu_loss, cpu = zoo_steps(mx, name, mx.cpu(), values, batches)
        gpu_loss, gpu = zoo_steps(mx, name, mx.gpu(0), values, batches)
        loss_err = max(abs(g - c) / abs(c)
                       for g, c in zip(gpu_loss, cpu_loss))
        held = held_ratio(gpu, cpu)
        ok = loss_err <= PARITY_TOL[0] and held[0] <= 1
        print(f"17d {name} parity float64: {steps} hybridized Trainer steps "
              f"at batch {batch}, {side}x{side}, card vs CPU: loss "
              f"{' '.join(f'{v:.6f}' for v in gpu_loss)}; max relative loss "
              f"err {loss_err:.2e}; {len(cpu)} parameter, moving statistic "
              f"and momentum arrays after step {steps} at {held[0]:.3f} of "
              f"the tolerance (worst {held[1]}) (rtol {PARITY_TOL[0]:g}, "
              f"atol {PARITY_TOL[1]:g}*max|array|) "
              f"{'ok' if ok else 'FAIL'} [{card}]")
        check(ok, f"17d {name}: the card's float64 steps disagree with the "
              "CPU's")
        out[name] = zoo_lane(mx, name, side, values, card)
        out[name]["worst"] = max(held[0], loss_err / PARITY_TOL[0])
        out[name]["s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    return out


def block_run(mx, build, inputs, ctx, values=None, fwd=None, grad=None):
    """`build(mx)` on `ctx` (initialized under the seed, or from
    `values`), run on `inputs` (numpy) under record in train mode, then
    backward from one seeded head per output; returns (values, outputs,
    input gradients, parameter gradients) as numpy.  `fwd(block, xs)`
    gives the outputs (default: the block's call); `grad` the inputs
    that take a gradient (default: every float input)."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy, block_params_to_numpy)
    block = build(mx)
    mx.random.seed(SEED)
    block.initialize(ctx=ctx)
    xs = [mx.nd.array(a, ctx=ctx, dtype=a.dtype) for a in inputs]
    which = [i for i, a in enumerate(inputs) if a.dtype.kind == "f"] \
        if grad is None else grad
    for i in which:
        xs[i].attach_grad()
    call = fwd or (lambda b, a: b(*a))
    if values is not None:
        with mx.autograd.predict_mode():
            call(block, xs)                 # deferred shapes
        block_params_from_numpy(block, values, ctx=ctx)
    with mx.autograd.record():
        out = call(block, xs)
    outs = list(out) if isinstance(out, (list, tuple)) else [out]
    rng = np.random.RandomState(SEED + 21)
    heads = [mx.nd.array(rng.standard_normal(o.shape).astype("f4"),
                         ctx=ctx) for o in outs]
    mx.autograd.backward(outs, heads)
    return (block_params_to_numpy(block), [o.asnumpy() for o in outs],
            [xs[i].grad.asnumpy() for i in which],
            {n: p.grad().asnumpy() for n, p in
             block.collect_params().items() if p.grad_req != "null"})


def blocks17_cases(mx):
    """(label, build, inputs, fwd, grad inputs) of 17e, at the shapes the
    blocks' users give them.  Each block is named ``b17_`` on both
    devices."""
    r = np.random.RandomState(SEED + 22)

    def f(*shape, scale=1.0):
        return (scale * r.standard_normal(shape)).astype("f4")

    def unroll(t):
        def fwd(cell, xs):
            out, states = cell.unroll(t, xs[0], merge_outputs=True)
            return [out] + list(states)
        return fwd

    def make(path, *args, **kw):
        def build(mx):
            obj = mx.gluon
            for part in path.split("."):
                obj = getattr(obj, part)
            return obj(*args, prefix="b17_", **kw)
        return build
    act = f(32, 256, 28, 28, scale=2.0)
    cases = [(name + (f"({args[0]})" if args else ""),
              make(f"nn.{name}", *args), [act], None, None)
             for name, args in (
                 ("LeakyReLU", (0.1,)), ("PReLU", ()), ("ELU", ()),
                 ("SELU", ()), ("GELU", ()), ("Swish", ()))]
    pred = f(128, 80, 11)                      # lstm_ocr's shapes (15a)
    label = r.randint(1, 11, (128, 4)).astype("f4")
    cases += [
        ("Embedding(10000, 200)", make("nn.Embedding", 10000, 200),
         [r.randint(0, 10000, (32, 35)).astype("f4")], None, []),
        ("InstanceNorm", make("nn.InstanceNorm", scale=True),
         [f(8, 64, 56, 56, scale=3.0)], None, None),
        ("Conv1DTranspose", make("nn.Conv1DTranspose", 32, 3, strides=2,
                                 padding=1, output_padding=1),
         [f(16, 64, 100)], None, None),
        ("Conv2DTranspose", make("nn.Conv2DTranspose", 128, 4, strides=2,
                                 padding=1), [f(64, 256, 16, 16)], None,
         None),
        ("Conv3DTranspose", make("nn.Conv3DTranspose", 16, 3, strides=2,
                                 padding=1, output_padding=1),
         [f(2, 16, 8, 16, 16)], None, None),
        ("ReflectionPad2D(3)", make("nn.ReflectionPad2D", 3),
         [f(8, 64, 64, 64)], None, None),
        ("PixelShuffle1D(4)", make("contrib.nn.PixelShuffle1D", 4),
         [f(16, 64, 256)], None, None),
        ("PixelShuffle2D(2)", make("contrib.nn.PixelShuffle2D", 2),
         [f(8, 64, 64, 64)], None, None),
        ("PixelShuffle3D(2)", make("contrib.nn.PixelShuffle3D", 2),
         [f(2, 64, 8, 16, 16)], None, None),
        ("CTCLoss NTC/NT", make("loss.CTCLoss"), [pred, label], None, [0]),
        ("CTCLoss TNC/TN", make("loss.CTCLoss", "TNC", "TN"),
         [np.ascontiguousarray(pred.transpose(1, 0, 2)),
          np.ascontiguousarray(label.T)], None, [0]),
        ("LSTMPCell(512, 128) x20", make("contrib.rnn.LSTMPCell", 512, 128),
         [f(32, 20, 200)], unroll(20), None),
        ("SyncBatchNorm", make("nn.SyncBatchNorm"),
         [f(32, 64, 28, 28, scale=2.0)], None, None)]
    for kind in ("RNN", "LSTM", "GRU"):
        for dims, spatial in ((1, (64,)), (2, (32, 32)), (3, (8, 16, 16))):
            name = f"Conv{dims}D{kind}Cell"
            cases.append((f"{name} x4", make(f"contrib.rnn.{name}",
                                            (16,) + spatial, 32, 3, 3,
                                            i2h_pad=1),
                          [f(4, 4, 16, *spatial)], unroll(4), None))
    return cases


def blocks17(mx, card):
    """17e: every block slice 15 added, on the card against the CPU in
    fp32 (TF32 off) from the same values and inputs: the outputs, the
    inputs' gradients and the parameters' gradients within each case's
    tolerance; the one-card SyncBatchNorm equals BatchNorm on the card
    (outputs, gradients, moving statistics)."""
    worst, tol = (0.0, "none"), BLOCK17_TOL
    for label, build, inputs, fwd, grad in blocks17_cases(mx):
        values, c_out, c_g, c_pg = block_run(mx, build, inputs, mx.cpu(),
                                             fwd=fwd, grad=grad)
        _, g_out, g_g, g_pg = block_run(mx, build, inputs, mx.gpu(0),
                                        values, fwd=fwd, grad=grad)
        ratios = [op_ratio(g, c, tol) for g, c in zip(g_out, c_out)] + \
            [op_ratio(g, c, tol) for g, c in zip(g_g, c_g)] + \
            [op_ratio(g_pg[n], c_pg[n], tol) for n in c_pg]
        w = max(ratios)
        finite = all(np.isfinite(o).all() for o in g_out)
        ok = w <= 1 and finite and len(g_out) == len(c_out)
        print(f"17e {label:28s} card vs CPU: {len(c_out)} outputs "
              f"{[tuple(o.shape) for o in c_out][:2]}, {len(c_g)} input and "
              f"{len(c_pg)} parameter gradients at {w:.3f} of the tolerance "
              f"(rtol {tol[0]:g}, atol {tol[1]:g}*max|ref|) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"17e {label}: the card disagrees with the CPU")
        worst = max(worst, (w, label))
    x = [np.random.RandomState(SEED + 23).standard_normal(
        (32, 64, 28, 28)).astype("f4")]
    sync = block_run(mx, lambda mx: mx.gluon.nn.SyncBatchNorm(prefix="bn_"),
                     x, mx.gpu(0))
    plain = block_run(mx, lambda mx: mx.gluon.nn.BatchNorm(prefix="bn_"), x,
                      mx.gpu(0))
    same = all(np.array_equal(a, b) for a, b in zip(
        sync[1] + sync[2] + list(sync[0].values()) + list(sync[3].values()),
        plain[1] + plain[2] + list(plain[0].values())
        + list(plain[3].values())))
    print(f"17e SyncBatchNorm on one card vs BatchNorm on the card: outputs, "
          f"gradients and moving statistics {'equal' if same else 'DIFFER'}")
    check(same, "17e: the one-card SyncBatchNorm is not BatchNorm")
    return worst


def zoo_phase(card, workdir):
    """Phase 17; returns K1's launches on its two paths and the numbers
    of the summary line.  K2 and K3 must not run."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    for wrapper in (flash_fwd, flash_fwd_stream):
        wrapper.launches = 0
    out, times = {}, {}
    old = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    try:
        for key, fn in (("17a", lambda: alex_parity(mx, card)),
                        ("17b", lambda: alex_lane(mx, card)),
                        ("17c", lambda: alex_serve(mx, out["17b"][0], card,
                                                   workdir))):
            t0 = time.perf_counter()
            out[key] = fn()
            times[key] = time.perf_counter() - t0
            print(f"phase {key}: {times[key]:.1f} s")
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        if old is not None:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    out["17b"] = out["17b"][1]
    gc.collect()
    torch.cuda.empty_cache()
    for key, fn in (("17d", lambda: zoo_families(mx, card)),
                    ("17e", lambda: blocks17(mx, card))):
        t0 = time.perf_counter()
        out[key] = fn()
        times[key] = time.perf_counter() - t0
        print(f"phase {key}: {times[key]:.1f} s")
    check([flash_fwd.launches, flash_fwd_stream.launches] == [0, 0],
          "phase 17: K2/K3 ran")
    out["times"] = times
    out["k1"] = {"alexnet_fit": out["17b"]["launches"],
                 "alexnet_serve": out["17c"]["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 18: gluon's data plane, DataLoaderIter, the gluon LM, SVRG --------

# 18a: a JPEG .rec at ImageNet's training size (phase 12's writer), read
# through gluon.data.vision as a gluon image script reads ImageNet: the
# deterministic pipeline of evaluation (Resize 256 keeping the ratio,
# CenterCrop 224, ToTensor, Normalize with ImageNet's mean and std) and
# the random one of training (RandomResizedCrop 224, a left-right flip,
# brightness, contrast and saturation jitter of 0.4)
LOADER18_CORPUS = dict(n=640, h=256, w=256)
LOADER18_RESIZE = 256           # the evaluation pipeline's short side
LOADER18_FOLDER = 64            # PNGs of an ImageFolderDataset tree
LOADER18_BATCH = 128
LOADER18_WORKERS = 8
LOADER18_RATES = (0, 8)         # workers of the timed random pipeline,
                                # a whole epoch each (a worker builds a
                                # whole batch, so a window shorter than
                                # the pipeline's fill reads low)
LOADER18_MEAN = (0.485, 0.456, 0.406)
LOADER18_STD = (0.229, 0.224, 0.225)
LOADER18_BAD = 300              # 18a: the sample that raises (batch 2)
LOADER18_RAISE_S = 5.0          # ... surfaced within this many seconds
                                # of the batch before it
LOADER18_DRAIN_S = 10.0         # workers gone this long after a break
# 18b: the bridge's fp32 steps at batch 8 (17a's batch), then 17b's lane
# (bf16, fp32 master weights, OPT17, Dropout 0.5) for 2 epochs of the
# corpus at batch 128
BRIDGE18 = (8, 3)
LANE18_EPOCHS = 2
# 18d: the gluon LM at LM_CFG's widths; parity as 10a (batch 2 x T 128,
# 3 steps, float64), the lane as 10b (8 x 1024, 4 warm + 8 timed steps,
# fp32 with TF32 off), each step's batch from a DataLoader of seeded
# token windows with 2 workers through the h2d ring
GLM18_PREFIX = "glm18_"
GLM18_LOADER_WORKERS = 2
# 18e: train_mnist's mlp through SVRGModule at phase 6's batch and
# learning rate without momentum (as the reference's SVRG examples run
# it: with phase 6's momentum 0.9 the trajectory is chaotic, a 1e-4
# relative change of the initial weights ending at chance), a snapshot
# every 2 epochs, 4 epochs; the card against the CPU over the first 8
# batches (one epoch with its snapshot pass)
SVRG18 = dict(update_freq=2, epochs=4, parity_batches=8)


def transforms18(mx, random_aug=False, dtype=None):
    """18a's pipelines as `transforms.Compose`: evaluation's, or
    training's with `random_aug`; a `Cast` to `dtype` at the end."""
    T = mx.gluon.data.vision.transforms
    size = IMAGE[1]
    if random_aug:
        steps = [T.RandomResizedCrop(size), T.RandomFlipLeftRight(),
                 T.RandomBrightness(0.4), T.RandomContrast(0.4),
                 T.RandomSaturation(0.4)]
    else:
        steps = [T.Resize(LOADER18_RESIZE, keep_ratio=True),
                 T.CenterCrop(size)]
    steps += [T.ToTensor(), T.Normalize(LOADER18_MEAN, LOADER18_STD)]
    if dtype is not None:
        steps.append(T.Cast(dtype))
    return T.Compose(steps)


def dataset18(mx, rec, random_aug=False, dtype=None):
    return mx.gluon.data.vision.ImageRecordDataset(rec).transform_first(
        transforms18(mx, random_aug, dtype))


class Head18:
    """The first `n` samples of a dataset (a gluon Dataset by duck type:
    a length and items by index); with `bad`, sample `bad` raises."""

    def __init__(self, ds, n=None, bad=None):
        self.ds, self.n, self.bad = ds, len(ds) if n is None else n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise ValueError(f"sample {i} is unreadable")
        return self.ds[i]


def host18(loader):
    """Every batch of `loader` as numpy arrays, in order."""
    return [[a.asnumpy() for a in b] for b in loader]


def same18(got, want):
    return len(got) == len(want) and all(
        len(g) == len(w) and all(a.dtype == b.dtype and a.shape == b.shape
                                 and np.array_equal(a, b)
                                 for a, b in zip(g, w))
        for g, w in zip(got, want))


def workers18():
    return [t for t in threading.enumerate()
            if t.name.startswith("mx-dataloader-worker")]


def folder18(mx, tmp):
    """An ImageFolderDataset tree of LOADER18_FOLDER PNGs (4 classes) of
    seeded pixels; returns (root, {path: pixels})."""
    from incubator_mxnet_tpu_torch import image
    pil, cv2 = image.pil_module(), image.cv2_module()
    root = os.path.join(tmp, "folder")
    pixels = {}
    for i in range(LOADER18_FOLDER):
        d = os.path.join(root, f"class{i % 4}")
        os.makedirs(d, exist_ok=True)
        img = np.random.RandomState(SEED + 1800 + i).randint(
            0, 256, (200 + i, 240, 3), np.uint8)
        path = os.path.join(d, f"{i:03d}.png")
        if pil is not None:
            pil.fromarray(img).save(path)
        else:
            check(cv2 is not None, "18a: no PNG codec (neither PIL nor "
                  "cv2 imports)")
            cv2.imwrite(path, img[:, :, ::-1])
        pixels[path] = img
    return root, pixels


def data18(mx, card, tmp, iter_rate):
    """18a: the data plane alone; returns the .rec and the rates."""
    from incubator_mxnet_tpu_torch import io_plane
    rec, fmt = imagenet_corpus(mx, tmp, LOADER18_CORPUS, "18a")
    ds = dataset18(mx, rec)
    loader = mx.gluon.data.DataLoader
    t0 = time.perf_counter()
    serial = host18(loader(ds, batch_size=LOADER18_BATCH))
    t_serial = time.perf_counter() - t0
    t0 = time.perf_counter()
    threaded = host18(loader(ds, batch_size=LOADER18_BATCH,
                             num_workers=LOADER18_WORKERS))
    t_threaded = time.perf_counter() - t0
    ok = same18(threaded, serial) and len(serial) == \
        LOADER18_CORPUS["n"] // LOADER18_BATCH
    print(f"18a loader: {len(serial)} batches of {LOADER18_BATCH} from the "
          f"{fmt[1:].upper()} .rec through Resize(256, keep_ratio), "
          f"CenterCrop(224), ToTensor, Normalize: {LOADER18_WORKERS} workers "
          f"= 0 workers bit for bit, in order ({t_threaded:.2f} s against "
          f"{t_serial:.2f} s) {'ok' if ok else 'FAIL'}")
    check(ok, "18a: the threaded loader's batches differ from one thread's")
    ring = io_plane.DevicePrefetchLoader(
        loader(ds, batch_size=LOADER18_BATCH, num_workers=LOADER18_WORKERS),
        ctx=mx.gpu(0))
    placed = [[a for a in b] for b in ring]
    on_card = all(a.context == mx.gpu(0) for b in placed for a in b)
    carried = ring.ring_stats()["batches"]
    ok = on_card and carried == len(serial) and same18(
        [[a.asnumpy() for a in b] for b in placed], serial)
    del placed
    print(f"18a DevicePrefetchLoader(ctx=gpu(0)): {carried} batches carried "
          f"by the ring, on the card bit for bit the host batches "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "18a: the ring's card batches differ from the host batches")

    root, pixels = folder18(mx, tmp)
    fds = mx.gluon.data.vision.ImageFolderDataset(root)
    items_ok = len(fds) == LOADER18_FOLDER and all(
        np.array_equal(fds[i][0].asnumpy(), pixels[path])
        and fds[i][1] == fds.synsets.index(os.path.basename(
            os.path.dirname(path)))
        for i, (path, _) in enumerate(fds.items))
    fds = fds.transform_first(transforms18(mx))
    ok = items_ok and same18(
        host18(loader(fds, batch_size=16, num_workers=LOADER18_WORKERS)),
        host18(loader(fds, batch_size=16)))
    print(f"18a ImageFolderDataset: {LOADER18_FOLDER} PNGs in 4 class "
          f"folders decode to their pixels and labels; the pipeline's "
          f"batches at {LOADER18_WORKERS} workers = 0 workers "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "18a: ImageFolderDataset's images or batches are wrong")

    bad = loader(Head18(ds, bad=LOADER18_BAD), batch_size=LOADER18_BATCH,
                 num_workers=LOADER18_WORKERS)
    got, err = 0, None
    t0 = last = time.perf_counter()
    try:
        for _ in bad:
            got += 1
            last = time.perf_counter()
    except ValueError as e:
        err = e
    end = time.perf_counter()
    want = LOADER18_BAD // LOADER18_BATCH
    ok = err is not None and got == want and end - last <= LOADER18_RAISE_S
    print(f"18a a sample that raises (index {LOADER18_BAD}): {err!r} at "
          f"batch {got} (want {want}), {end - last:.2f} s after batch "
          f"{got - 1} came (at most {LOADER18_RAISE_S:g}; {end - t0:.2f} s "
          f"from the start) {'ok' if ok else 'FAIL'}")
    check(ok, "18a: a worker's exception did not surface at its batch")
    it = iter(loader(ds, batch_size=LOADER18_BATCH,
                     num_workers=LOADER18_WORKERS))
    next(it)
    next(it)
    live = len(workers18())
    del it
    t0 = time.perf_counter()
    while workers18() and time.perf_counter() - t0 < LOADER18_DRAIN_S:
        time.sleep(0.05)
    left = len(workers18())
    print(f"18a break after 2 batches: {live} workers running, "
          f"{left} alive {time.perf_counter() - t0:.2f} s after the "
          f"iterator was dropped {'ok' if not left else 'FAIL'}")
    check(not left, "18a: loader workers outlived their iterator")

    rds = dataset18(mx, rec, random_aug=True)
    rates, first, cores = {}, {}, {}
    n = LOADER18_CORPUS["n"]
    for workers in LOADER18_RATES:
        it = iter(loader(rds, batch_size=LOADER18_BATCH,
                         num_workers=workers))
        c0, t0 = time.process_time(), time.perf_counter()
        for k, _ in enumerate(it):
            if k == 0:
                first[workers] = time.perf_counter() - t0
        wall = time.perf_counter() - t0
        rates[workers] = n / wall
        # the process's CPU seconds a wall second: how many host cores
        # the loader kept busy (its threads and torch's intra-op pool)
        cores[workers] = (time.process_time() - c0) / wall
    print(f"18a random pipeline (RandomResizedCrop 224, RandomFlipLeftRight, "
          f"Brightness/Contrast/Saturation 0.4, ToTensor, Normalize), "
          f"a whole epoch of {n} images: " + ", ".join(
              f"{w} workers {rates[w]:.1f} images/s (first batch after "
              f"{first[w]:.2f} s, {cores[w]:.2f} cores busy)"
              for w in rates)
          + f"; phase 12's ImageRecordIter alone {iter_rate:.1f} images/s "
          f"({os.cpu_count()} host cores) [{card}]")
    return rec, {"rates": rates, "first_s": first, "cores": cores,
                 "serial_s": t_serial, "threaded_s": t_threaded,
                 "format": fmt}


def bridge18(mx, card, rec):
    """18b, first: BRIDGE18 fp32 Module.fit steps of AlexNet (Dropout 0,
    OPT17) fed by DataLoaderIter over a threaded loader, against the
    same steps fed by NDArrayIter over the same host batches, from the
    same Xavier parameters, with cuDNN deterministic: bit for bit, or
    else within 17a's gate."""
    from incubator_mxnet_tpu_torch.contrib.io import DataLoaderIter
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    batch, steps = BRIDGE18
    alex_k1_held(batch, F32, "18b")
    _, sym = alex_symbol(mx, 0.0)
    ds = Head18(dataset18(mx, rec), batch * steps)
    host = host18(mx.gluon.data.DataLoader(ds, batch_size=batch))
    x = np.concatenate([b[0] for b in host])
    y = np.concatenate([b[1] for b in host])

    def fit(it):
        mod = mx.mod.Module(sym, context=mx.gpu(0))
        mx.random.seed(SEED)
        mod.fit(it, num_epoch=1, optimizer="sgd",
                optimizer_params=dict(OPT17, rescale_grad=1.0 / batch),
                initializer=resnet_init(mx), kvstore=None)
        check(mod._fused_step is not None and mod._fused_step.steps ==
              steps, "18b: the fused step did not take every bridge step")
        return {n: v.asnumpy() for n, v in mod.get_params()[0].items()}

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        fc_relu.launches = 0
        got = fit(DataLoaderIter(mx.gluon.data.DataLoader(
            ds, batch_size=batch, num_workers=LOADER18_WORKERS)))
        launches = fc_relu.launches
        want = fit(mx.io.NDArrayIter(x, y, batch))
    finally:
        torch.backends.cudnn.deterministic = det
    bitwise = all(np.array_equal(got[n], want[n]) for n in want)
    ratio = param_ratio(got, want)
    ok = (bitwise or ratio[0] <= 1) and launches == 2 * steps
    print(f"18b bridge: {steps} fp32 Module.fit steps of AlexNet at batch "
          f"{batch} fed by DataLoaderIter ({LOADER18_WORKERS} workers) vs "
          f"NDArrayIter over the same host batches, cuDNN deterministic: "
          f"parameters {'bit for bit' if bitwise else 'not bitwise'}, "
          f"{ratio[0]:.3f} of 17a's gate (worst {ratio[1]}); K1 {launches} "
          f"launches = 2 x {steps} {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "18b: DataLoaderIter's steps differ from NDArrayIter's")
    return {"bitwise": bitwise, "ratio": ratio[0], "launches": launches}


def lane18(mx, card, rec, resident_images_s):
    """18b: AlexNet (17b's net, dtype and settings) through Module.fit
    fed by DataLoaderIter over the 18a loader (the deterministic
    pipeline cast to bf16 on the workers, LOADER18_WORKERS threads), for
    LANE18_EPOCHS epochs; K1's count set to 0 before the fit and read
    after (2 a train forward, no eval); images/s over the last epoch
    (its first batch's wait included) against 17b's resident rate."""
    from incubator_mxnet_tpu_torch.contrib.io import DataLoaderIter
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    batch = LOADER18_BATCH
    alex_k1_held(batch, BF16, "18b")
    _, sym = alex_symbol(mx, DROP_RATE)
    it = DataLoaderIter(mx.gluon.data.DataLoader(
        dataset18(mx, rec, dtype="bfloat16"), batch_size=batch,
        num_workers=LOADER18_WORKERS))
    per_epoch = LOADER18_CORPUS["n"] // batch
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    ce = mx.metric.create("ce")
    losses, edges, events = [], {}, []

    def probe(p):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        label = mod._exec_group.execs[0].arg_dict["softmax_label"]
        total, n = ce.device_update([label], mod.get_outputs())
        losses.append(total / n)
        if p.nbatch == per_epoch - 1:
            torch.cuda.synchronize()
            edges[p.epoch] = time.perf_counter()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fc_relu.launches = 0
    mx.random.seed(SEED)
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=LANE18_EPOCHS, optimizer="sgd",
            optimizer_params=dict(OPT17, multi_precision=True,
                                  rescale_grad=1.0 / batch),
            eval_metric="acc", initializer=resnet_init(mx),
            batch_end_callback=probe, kvstore=None)
    wall = time.perf_counter() - t0
    launches = fc_relu.launches
    steps = per_epoch * LANE18_EPOCHS
    fused = mod._fused_step
    dt = mod._exec_group.execs[0].arg_dict["data"].data.dtype
    loss = torch.stack(losses).float().cpu().numpy()
    images_s = batch * per_epoch / (edges[LANE18_EPOCHS - 1] -
                                    edges[LANE18_EPOCHS - 2])
    step_ms = statistics.median(a.elapsed_time(b) for a, b in
                                zip(events, events[1:]))
    ok = fused is not None and fused.steps == steps and \
        launches == 2 * steps and np.isfinite(loss).all() and \
        dt == torch.bfloat16
    print(f"18b alexnet from the loader: {LANE18_EPOCHS} epochs of "
          f"{per_epoch} batches of {batch} ({str(dt)[6:]} data cast on the "
          f"workers) through DataLoaderIter + Module.fit in {wall:.2f} s, "
          f"fused step {fused.steps if fused else 0} of {steps}; K1 "
          f"{launches} launches = 2 x {steps} train forwards + 0 (no eval) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    ratio = images_s / resident_images_s
    print(f"18b alexnet from the loader: {images_s:.1f} images/s over "
          f"epoch {LANE18_EPOCHS} (its first batch's wait included), step "
          f"median {step_ms:.3f} ms (CUDA events), peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"loader_vs_resident {ratio:.3f} (17b resident "
          f"{resident_images_s:.1f} images/s); loss first {loss[0]:.4f} "
          f"last {loss[-1]:.4f} [{card}]")
    check(ok, "18b: the loader-fed AlexNet lane failed")
    del mod
    gc.collect()
    torch.cuda.empty_cache()
    return {"images_s": images_s, "step_ms": step_ms, "launches": launches,
            "loader_vs_resident": ratio, "steps": steps}


def est18(mx, card, rec):
    """18c: the gluon AlexNet (Dropout 0: the fused gluon step declines
    a net that draws), bf16 with fp32 master weights, hybridized, through
    Estimator.fit over the 18a loader with ``MXNET_IO_RING`` on: the
    fused step takes every batch and the ring carries every batch."""
    from incubator_mxnet_tpu_torch import config as _config
    from incubator_mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    check(_config.get("MXNET_IO_RING"), "18c: MXNET_IO_RING is off")
    batch = LOADER18_BATCH
    net = alex_net(mx, 0.0)
    mx.random.seed(SEED)
    net.initialize(resnet_init(mx), ctx=mx.gpu(0))
    with mx.autograd.pause():          # the deferred shapes, then bf16
        net(mx.nd.zeros((2,) + IMAGE, ctx=mx.gpu(0)))
    net.cast("bfloat16")
    net.hybridize()
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(OPT17, multi_precision=True))
    loader = mx.gluon.data.DataLoader(
        dataset18(mx, rec, dtype="bfloat16"), batch_size=batch,
        num_workers=LOADER18_WORKERS)
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    train_metrics=[mx.metric.Accuracy()], trainer=trainer,
                    context=mx.gpu(0))
    gc.collect()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(loader, epochs=1, event_handlers=[])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(loader)
    steps = est._fused.steps if est._fused is not None else 0
    carried = est.io_loader.ring_stats().get("batches", 0) \
        if est.io_loader is not None else 0
    images_s = LOADER18_CORPUS["n"] / wall
    ok = steps == n and carried == n
    print(f"18c Estimator.fit: hybridized gluon AlexNet (Dropout 0), bf16, "
          f"one epoch of {n} batches of {batch} from the loader: fused "
          f"gluon step {steps} of {n}, the ring carried {carried}; "
          f"{images_s:.1f} images/s over the epoch (first batch's wait "
          f"included) {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "18c: the fused step or the ring missed a batch")
    del est, net, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return {"images_s": images_s, "steps": steps, "carried": carried}


def glm18_net(mx, ctx, values=None, dtype="float32", init=True,
              layers=LM_CFG["num_layers"]):
    """The gluon TransformerLM at LM_CFG's widths, `layers` deep, under
    GLM18_PREFIX on `ctx`: `values` loaded, or phase 10's initialisation
    (Xavier under mx.random.seed(SEED)); `dtype` float64 casts it,
    bfloat16 builds it with bf16 parameters."""
    from incubator_mxnet_tpu_torch.compat.weights import (
        block_params_from_numpy)
    from incubator_mxnet_tpu_torch.llm import TransformerLM
    cfg = lm_train_cfg(param_dtype="bfloat16" if dtype == "bfloat16"
                       else "float32", num_layers=layers)
    net = TransformerLM(cfg, prefix=GLM18_PREFIX)
    mx.random.seed(SEED)
    net.initialize(mx.initializer.Xavier(), ctx=ctx)
    if dtype == "float64":
        net.cast("float64")
    if values is not None:
        block_params_from_numpy(net, values, ctx=ctx)
    return net


def glm18_windows(n, t, seed):
    """`n` seeded token windows: (n, t) int32 inputs, the next tokens as
    float32 labels."""
    x = np.random.RandomState(seed).randint(1, LM_CFG["vocab_size"],
                                            (n, t + 1))
    return x[:, :-1].astype(np.int32), x[:, 1:].astype(np.float32)


def glm18_state(net, trainer):
    params = {k: v.data().asnumpy() for k, v in
              net.collect_params().items()}
    moms = {trainer._params[i].name: st.asnumpy()
            for i, st in trainer._updaters[0].states.items()
            if st is not None}
    return params, moms


def glm18_plain(mx, ctx, values, xs, ys):
    """10a's steps through gluon's plain loop in float64 on `ctx`: per
    step the mean loss, the embed_weight gradient, the state after."""
    net = glm18_net(mx, ctx, values, "float64",
                    layers=LM_TRAIN_PARITY_LAYERS)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(LM_TRAIN_OPT))
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    out = []
    for x, y in zip(xs, ys):
        with mx.autograd.record():
            loss = loss_fn(net(mx.nd.array(x, ctx=ctx, dtype="int32")),
                           mx.nd.array(y, ctx=ctx, dtype="float64"))
        loss.backward()
        grad = net.collect_params()[GLM18_PREFIX + "embed_weight"].grad() \
            .asnumpy()
        trainer.step(x.shape[0])
        out.append((float(loss.asnumpy().mean()), grad,
                    glm18_state(net, trainer)))
    del net, trainer
    gc.collect()
    return out


def glm18_parity(mx, card):
    """18d (i) and (ii): LM_TRAIN_PARITY's steps of the plain loop in
    float64, card against CPU from the same Xavier parameters and
    batches: each step's loss, the first step's tied embed_weight
    gradient, every parameter and momentum after each step (10a's
    gates); then Estimator.fit with the fused gluon step on the card over
    a loader of the same batches against the card's plain loop."""
    from incubator_mxnet_tpu_torch.compat.weights import block_params_to_numpy
    from incubator_mxnet_tpu_torch.gluon.contrib.estimator import Estimator
    batch, t, steps = LM_TRAIN_PARITY
    x, y = glm18_windows(batch * steps, t, SEED + 180)
    xs, ys = x.reshape(steps, batch, t), y.reshape(steps, batch, t)
    values = block_params_to_numpy(glm18_net(
        mx, mx.cpu(), dtype="float64", layers=LM_TRAIN_PARITY_LAYERS))
    cpu = glm18_plain(mx, mx.cpu(), values, xs, ys)
    gpu = glm18_plain(mx, mx.gpu(0), values, xs, ys)
    loss_err = max(abs(g[0] - c[0]) / abs(c[0]) for g, c in zip(gpu, cpu))
    grad = param_ratio({"g": gpu[0][1]}, {"g": cpu[0][1]})[0]
    worst = max(max(param_ratio(g[2][0], c[2][0]),
                    param_ratio(g[2][1], c[2][1])) for g, c in zip(gpu, cpu))
    ok = loss_err <= PARITY_TOL[0] and grad <= 1 and worst[0] <= 1
    print(f"18d gluon LM parity float64: {steps} plain-loop steps (record, "
          f"backward, Trainer.step; SGD lr {LM_TRAIN_OPT['learning_rate']} "
          f"momentum {LM_TRAIN_OPT['momentum']}) at batch {batch} x T {t}, "
          f"{LM_TRAIN_PARITY_LAYERS} of GPT-2 small's {LM_CFG['num_layers']}"
          f" layers x {LM_CFG['hidden']}, vocab "
          f"{LM_CFG['vocab_size']}, card vs CPU: loss "
          f"{' '.join(f'{g[0]:.6f}' for g in gpu)}, max relative err "
          f"{loss_err:.2e} (rtol {PARITY_TOL[0]:g}); tied embed_weight "
          f"gradient at {grad:.3f} of the tolerance; parameters and momenta "
          f"after each step at {worst[0]:.3f} of it (worst {worst[1]}) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "18d: the gluon LM's card steps disagree with the CPU's")
    net = glm18_net(mx, mx.gpu(0), values, "float64",
                    layers=LM_TRAIN_PARITY_LAYERS)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               dict(LM_TRAIN_OPT))
    est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                    train_metrics=[mx.metric.Accuracy(axis=-1)],
                    trainer=trainer, context=mx.gpu(0))
    est.fit(mx.gluon.data.DataLoader(mx.gluon.data.ArrayDataset(
        x, y.astype(np.float64)), batch_size=batch), epochs=1,
        event_handlers=[])
    fused = est._fused.steps if est._fused is not None else 0
    got = glm18_state(net, trainer)
    est_worst = max(param_ratio(got[0], gpu[-1][2][0]),
                    param_ratio(got[1], gpu[-1][2][1]))
    ok = fused == steps and est_worst[0] <= 1
    print(f"18d gluon LM Estimator.fit float64 on the card: fused gluon step "
          f"{fused} of {steps}; parameters and momenta against the card's "
          f"plain loop at {est_worst[0]:.3f} of 10a's tolerance (worst "
          f"{est_worst[1]}) {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "18d: Estimator's fused LM steps differ from the plain loop")
    del est, net, trainer, cpu, gpu
    gc.collect()
    torch.cuda.empty_cache()
    return {"worst": max(worst[0], loss_err / PARITY_TOL[0], grad),
            "estimator": est_worst[0]}


def glm18_lane(mx, card, dtype, fused_on):
    """18d (iii): LM_TRAIN_LANE's steps of the gluon LM through
    Estimator.fit, fed by a DataLoader of seeded token windows
    (GLM18_LOADER_WORKERS workers) through DevicePrefetchLoader: fused
    gluon step (or the eager loop), tokens/s over CUDA-synchronised
    edges, the median step ms between CUDA events, peak memory."""
    from incubator_mxnet_tpu_torch import io_plane
    from incubator_mxnet_tpu_torch.gluon.contrib.estimator import (
        Estimator, EventHandler)
    batch, t, warm, timed = LM_TRAIN_LANE
    steps = warm + timed
    x, y = glm18_windows(batch * steps, t, SEED + 181)
    old = os.environ.get("MXNET_FUSED_TRAIN_STEP")
    os.environ["MXNET_FUSED_TRAIN_STEP"] = "1" if fused_on else "0"
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        net = glm18_net(mx, mx.gpu(0), dtype=dtype)
        trainer = mx.gluon.Trainer(
            net.collect_params(), "sgd",
            dict(LM_TRAIN_OPT, multi_precision=dtype == "bfloat16"))
        loader = io_plane.DevicePrefetchLoader(mx.gluon.data.DataLoader(
            mx.gluon.data.ArrayDataset(x, y), batch_size=batch,
            num_workers=GLM18_LOADER_WORKERS), ctx=mx.gpu(0))
        events, edges, losses = [], {}, []

        class Probe(EventHandler):
            def batch_end(self, est):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                events.append(ev)
                last = est._fused.last_loss if est._fused is not None \
                    else None
                if last is not None:
                    losses.append(last.data.float().mean())
                if est.batch_idx in (warm - 1, steps - 1):
                    torch.cuda.synchronize()
                    edges[est.batch_idx] = time.perf_counter()

        est = Estimator(net, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                        train_metrics=[mx.metric.Accuracy(axis=-1)],
                        trainer=trainer, context=mx.gpu(0))
        est.fit(loader, epochs=1, event_handlers=[Probe()])
        fused = est._fused.steps if est._fused is not None else 0
        carried = loader.ring_stats()["batches"]
        n_params = sum(p.data().size for p in
                       net.collect_params().values())
    finally:
        os.environ.pop("MXNET_FUSED_TRAIN_STEP", None)
        if old is not None:
            os.environ["MXNET_FUSED_TRAIN_STEP"] = old
    tokens_s = batch * t * timed / (edges[steps - 1] - edges[warm - 1])
    step_ms = statistics.median(a.elapsed_time(b) for a, b in
                                zip(events[warm - 1:], events[warm:]))
    cfg = lm_train_cfg()
    flops = lm_train_flops(n_params, cfg, batch, t)
    peak = FP32_CUDA_CORE_FLOPS if dtype == "float32" else PEAK_FLOPS[BF16]
    mfu = tokens_s * flops / (batch * t) / peak
    mem = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = [float(v) for v in torch.stack(losses).cpu()] if losses else []
    ok = fused == (steps if fused_on else 0) and carried == steps and \
        bool(np.isfinite(loss).all())
    label = f"{dtype} {'fused' if fused_on else 'eager'}"
    print(f"18d gluon LM lane {label}: {steps} steps at batch {batch} x T "
          f"{t} through Estimator.fit, the loader's {carried} batches "
          f"through the ring, fused gluon step {fused}; {tokens_s:.1f} "
          f"tokens/s over the {timed} timed steps, step median "
          f"{step_ms:.3f} ms, mfu {mfu:.4f} (of {peak / 1e12:.0f} TFLOP/s), "
          f"peak {mem:.2f} GiB"
          + (f"; loss first {loss[0]:.4f} last {loss[-1]:.4f}" if loss
             else "") + f" {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, f"18d: the gluon LM lane ({label}) failed")
    del est, net, trainer, loader
    gc.collect()
    torch.cuda.empty_cache()
    return {"tokens_s": tokens_s, "step_ms": step_ms, "mfu": mfu,
            "peak_gib": mem}


def glm18(mx, card, module_tokens_s):
    """18d: the gluon LM's parity and lanes; K1, K2, K3 at 0 launches."""
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    wrappers = (fc_relu, flash_fwd, flash_fwd_stream)
    for w in wrappers:
        w.launches = 0
    out = {"parity": glm18_parity(mx, card)}
    out["fp32"] = glm18_lane(mx, card, "float32", True)
    out["eager"] = glm18_lane(mx, card, "float32", False)
    out["bf16"] = glm18_lane(mx, card, "bfloat16", True)
    launches = [w.launches for w in wrappers]
    out["fused_vs_eager"] = out["fp32"]["tokens_s"] / out["eager"]["tokens_s"]
    out["gluon_vs_module"] = out["fp32"]["tokens_s"] / module_tokens_s
    print(f"18d gluon LM: fp32 fused {out['fp32']['tokens_s']:.1f} tokens/s, "
          f"eager {out['eager']['tokens_s']:.1f} (fused_vs_eager "
          f"{out['fused_vs_eager']:.3f}), bf16 fused "
          f"{out['bf16']['tokens_s']:.1f}; gluon_vs_module "
          f"{out['gluon_vs_module']:.3f} (phase 10b's Module.fit "
          f"{module_tokens_s:.1f} tokens/s); K1/K2/K3 launches {launches} "
          f"[{card}]")
    check(launches == [0, 0, 0], "18d: a K1/K2/K3 kernel ran on the LM path")
    return out


def svrg18_fit(mx, ctx, x, y, epochs, callbacks=(), shuffle=False):
    """SVRGModule.fit of train_mnist's mlp on `ctx` (phase 6's batch,
    SGD at its learning rate without momentum, Xavier, under
    mx.random.seed(SEED)); the ce of each batch."""
    from incubator_mxnet_tpu_torch.contrib.svrg_optimization import (
        SVRGModule)
    np.random.seed(SEED)
    it = mx.io.NDArrayIter(x, y, TRAIN_BATCH, shuffle=shuffle)
    mod = SVRGModule(mlp_symbol(mx), update_freq=SVRG18["update_freq"],
                     context=ctx)
    seen = []

    def read(p):
        seen.append(p.eval_metric.get()[1])

    mx.random.seed(SEED)
    mod.fit(it, num_epoch=epochs, eval_metric="ce", optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR},
            initializer=mx.initializer.Xavier(),
            batch_end_callback=[read] + list(callbacks))
    return mod, seen


def svrg18(mx, card, tmp):
    """18e: train_mnist's mlp under TPU_PALLAS through SVRGModule on
    phase 6's synthetic MNIST: the card against the CPU over the first
    SVRG18 parity batches (phase 6's gate), then SVRG18's epochs on the
    card with a LogMetricsCallback; K1 2 a forward, each step two
    forward-backward passes and each snapshot pass one per batch."""
    from incubator_mxnet_tpu_torch.contrib.tensorboard import (
        LogMetricsCallback)
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    k1_held(TRAIN_BATCH, "18e")
    x, y = mx.test_utils.get_mnist_like(TRAIN_IMAGES)
    x, y = x[:TRAIN_SPLIT], y[:TRAIN_SPLIT]
    n = SVRG18["parity_batches"] * TRAIN_BATCH
    cpu_mod, cpu_ce = svrg18_fit(mx, mx.cpu(), x[:n], y[:n], 1)
    fc_relu.launches = 0
    gpu_mod, gpu_ce = svrg18_fit(mx, mx.gpu(0), x[:n], y[:n], 1)
    parity_launches = fc_relu.launches
    cpu_p = {k: v.asnumpy() for k, v in cpu_mod.get_params()[0].items()}
    gpu_p = {k: v.asnumpy() for k, v in gpu_mod.get_params()[0].items()}
    ratio = param_ratio(gpu_p, cpu_p)
    ce_err = max(abs(g - c) / abs(c) for g, c in zip(gpu_ce, cpu_ce))
    steps = SVRG18["parity_batches"]
    want = 2 * (steps * 2 + steps)
    ok = ratio[0] <= 1 and ce_err <= PARITY_TOL[0] and \
        parity_launches == want
    print(f"18e svrg parity: {steps} SVRG steps (update_freq "
          f"{SVRG18['update_freq']}, a snapshot pass of {steps} batches) "
          f"of train_mnist's mlp at batch {TRAIN_BATCH}, card vs CPU: "
          f"running ce max relative err {ce_err:.2e} (rtol "
          f"{PARITY_TOL[0]:g}); parameters at {ratio[0]:.3f} of phase 6's "
          f"tolerance (worst {ratio[1]}); K1 {parity_launches} launches = "
          f"2 x ({steps} steps x 2 + {steps} snapshot batches) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "18e: the card's SVRG steps disagree with the CPU's")
    del cpu_mod, gpu_mod
    logdir = os.path.join(tmp, "svrg_tb")
    board = LogMetricsCallback(logdir, prefix="svrg")
    records = []
    add = board._writer.add_scalar

    def counted(tag, value, step=None):
        records.append((tag, step))
        add(tag, value, step)

    board._writer.add_scalar = counted
    epochs = SVRG18["epochs"]
    nb = TRAIN_SPLIT // TRAIN_BATCH
    fc_relu.launches = 0
    t0 = time.perf_counter()
    mod, ce = svrg18_fit(mx, mx.gpu(0), x, y, epochs, callbacks=[board],
                         shuffle=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fc_relu.launches
    board.close()
    jsonl = os.path.join(logdir, "events.jsonl")
    lines = sum(1 for _ in open(jsonl)) if os.path.exists(jsonl) else None
    snapshots = len(range(0, epochs, SVRG18["update_freq"]))
    want = 2 * (epochs * nb * 2 + snapshots * nb)
    first, last = ce[nb - 1], ce[-1]
    ok = launches == want and len(records) == epochs * nb and \
        lines in (None, epochs * nb) and last < first and \
        all(math.isfinite(v) for v in ce)
    print(f"18e svrg fit: {epochs} epochs of {nb} batches in {wall:.2f} s; "
          f"ce over epoch 1 {first:.4f}, over epoch {epochs} {last:.4f}; "
          f"K1 {launches} launches = 2 x ({epochs} epochs x {nb} steps x 2 "
          f"+ {snapshots} snapshots x {nb} batches) = {want}; "
          f"LogMetricsCallback wrote {len(records)} records ("
          f"{type(board._writer).__name__}"
          + (f", {lines} lines in events.jsonl" if lines is not None
             else "") + f") for {epochs * nb} batches "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "18e: SVRGModule.fit's count, metric log or loss is wrong")
    return {"launches": launches, "parity_launches": parity_launches,
            "ratio": ratio[0], "ce": (first, last), "wall_s": wall}


def loader_phase(card, workdir, refs):
    """Phase 18; `refs` holds phase 12's iterator rate (``iter_rate``),
    17b's resident AlexNet rate (``resident``) and 10b's Module.fit LM
    rate (``lm_tokens_s``).  Returns K1's launches on its two paths and
    the numbers of the summary line.  K2 and K3 must not run."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    for wrapper in (flash_fwd, flash_fwd_stream):
        wrapper.launches = 0
    out, times = {}, {}
    old = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    tmp = tempfile.mkdtemp(dir=workdir)
    try:
        steps = (("18a", lambda: data18(mx, card, tmp, refs["iter_rate"])),
                 ("18b", lambda: (bridge18(mx, card, out["18a"][0]),
                                  lane18(mx, card, out["18a"][0],
                                         refs["resident"]))),
                 ("18c", lambda: est18(mx, card, out["18a"][0])),
                 ("18d", lambda: glm18(mx, card, refs["lm_tokens_s"])),
                 ("18e", lambda: svrg18(mx, card, tmp)))
        for key, fn in steps:
            t0 = time.perf_counter()
            out[key] = fn()
            times[key] = time.perf_counter() - t0
            print(f"phase {key}: {times[key]:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        if old is not None:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    check([flash_fwd.launches, flash_fwd_stream.launches] == [0, 0],
          "phase 18: K2/K3 ran")
    bridge, lane = out["18b"]
    out["times"] = times
    out["k1"] = {"loader_fit": bridge["launches"] + lane["launches"],
                 "svrg": out["18e"]["parity_launches"]
                 + out["18e"]["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 19: sparse storage, ONNX and INT8 (slice 17) -------------------------

# 19a: upstream MXNet's example/sparse/linear_classification reads avazu
# at 1 000 000 features; its rows hold ~15 one-hot fields.  The batch is
# cut from the example's 8192 to 256, so the dense input the port binds
# (its operators densify, as the JAX package's do) stays <= 1 GiB.
SPARSE19 = dict(features=1_000_000, nnz=15, batch=256, batches=4)
SPARSE19_OPT = {"learning_rate": 0.1, "momentum": 0.9}
SPARSE19_TOL = DP_TOL          # 4 steps card vs CPU: sums in other orders
SERVE19_SIZES = SOLO_ROWS      # 19b/19c requests, one per bucket
RESNET19_BATCH = 8             # 19b: ResNet-50 v1 round trip
ROUNDTRIP19_TOL = (1e-4, 1e-5)
CALIB19 = dict(images=32, batch=16)   # 19c: naive calibration batches
RATE19 = dict(warm=2, timed=10)       # 19b/19c: bucket-32 images/s
INT8_TIE = 1e-3       # 19c: a pre-round value this near a .5 may flip
INT8_FC_ROWS = (1, 8, 17, 32)          # 19c: the int8 FC route, K = 4096
DEV19 = "cuda"        # the card's torch device (a CPU rehearsal sets "cpu")


def unique_names(mx, sym, prefix):
    """`sym` with every op node named ``fwd`` (gluon's traced names)
    renamed: after its weight (``vgg0_dense0_fwd``), else after its op
    and a count; variables keep theirs.  quantize_model's
    ``excluded_sym_names`` and ONNX's output names need one node a
    name."""
    js = json.loads(sym.tojson())
    names = [n["name"] for n in js["nodes"]]
    seen = {}
    for node in js["nodes"]:
        if node["op"] == "null" or node["name"] != "fwd":
            continue
        weights = [names[i] for i, _, _ in node["inputs"]
                   if names[i].endswith("_weight")]
        if weights:
            node["name"] = weights[0][:-len("weight")] + "fwd"
        else:
            k = node["op"].lower()
            seen[k] = seen.get(k, -1) + 1
            node["name"] = f"{prefix}{k}{seen[k]}_fwd"
    return mx.sym.load_json(json.dumps(js))


def vgg_k1_held(where):
    """Fail unless phase 3 held K1 against fc_relu_ref at VGG-16's fc6
    and fc7 for every serving bucket in fp32."""
    held = {(mm, k, n, dt) for k, n in VGG_FC_SHAPES
            for mm in K1_ROWS for dt in (F32, BF16, F16)}
    check(all((m, k, n, F32) in held for m in BUCKETS
              for k, n in VGG_FC_SHAPES),
          f"{where}: VGG-16's K1 shapes were not held in phase 3")


def libsvm19(path, cfg, seed):
    """Seeded LibSVM rows at the linear_classification example's width:
    -> (labels, per-row sorted feature ids, per-row values)."""
    rng = np.random.RandomState(seed)
    n = cfg["batch"] * cfg["batches"]
    labels = rng.randint(0, 2, n)
    ids = np.sort(rng.randint(0, cfg["features"], (n, cfg["nnz"])), axis=1)
    while True:         # a row's features are distinct: redraw repeats
        dup = (np.diff(ids, axis=1) == 0).any(axis=1)
        if not dup.any():
            break
        ids[dup] = np.sort(rng.randint(0, cfg["features"],
                                       (int(dup.sum()), cfg["nnz"])), axis=1)
    vals = rng.rand(n, cfg["nnz"]).astype(np.float32)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"{labels[i]} " + " ".join(
                f"{c}:{v!r}" for c, v in zip(ids[i], vals[i].tolist()))
                + "\n")
    return labels.astype(np.float32), ids, vals


def rows19(ids, vals, lo, hi, features, device):
    """Rows [lo, hi) dense, built from the generator's arrays (not through
    the port's CSR), on `device`."""
    out = torch.zeros((hi - lo, features), dtype=torch.float32,
                      device=device)
    r = torch.arange(hi - lo, device=device).repeat_interleave(ids.shape[1])
    out[r, torch.from_numpy(ids[lo:hi].reshape(-1)).to(device)] = \
        torch.from_numpy(vals[lo:hi].reshape(-1)).to(device)
    return out


def sparse19(mx, card, tmp):
    """19a: LibSVM batches through Module.fit on the card."""
    from incubator_mxnet_tpu_torch import io_plane
    from incubator_mxnet_tpu_torch.ndarray import sparse
    cfg = SPARSE19
    F, B = cfg["features"], cfg["batch"]
    path = os.path.join(tmp, "avazu.libsvm")
    t0 = time.perf_counter()
    labels, ids, vals = libsvm19(path, cfg, SEED + 19)
    gen_s = time.perf_counter() - t0
    dev = torch.device(DEV19)

    # the first CSR batch densified on the card = the generator's rows
    it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(F,), batch_size=B)
    batch = it.next()
    csr = batch.data[0]
    check(isinstance(csr, sparse.CSRNDArray) and csr.shape == (B, F),
          f"19a: LibSVMIter yields {type(csr).__name__} {csr.shape}")
    parts = sum(t.nbytes for t in csr._parts.values())
    dense = sparse.dense_tensor(csr, dev)
    truth = rows19(ids, vals, 0, B, F, dev)
    bitwise = torch.equal(dense, truth)
    print(f"19a sparse: {B * cfg['batches']} LibSVM rows of {F} features "
          f"({cfg['nnz']} a row) written in {gen_s:.1f} s; a batch of {B} "
          f"densified on the card from its parts ({parts} bytes, "
          f"{dense.nbytes / 2 ** 30:.3f} GiB dense) = the generator's "
          f"rows {'bit for bit' if bitwise else 'FAIL'}")
    check(bitwise, "19a: the CSR batch densified on the card differs")
    del dense

    # 4 steps through Module.fit, card (the h2d ring on) vs CPU
    w0 = (np.random.RandomState(SEED + 20).randn(2, F) * 0.01).astype(
        np.float32)

    def fit(ctx):
        it = mx.io.LibSVMIter(data_libsvm=path, data_shape=(F,),
                              batch_size=B)
        h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=2,
                                  name="fc")
        mod = mx.mod.Module(mx.sym.SoftmaxOutput(h, name="softmax"),
                            context=ctx)
        before = io_plane.stats()
        stamps = [time.perf_counter()]
        mod.fit(it, num_epoch=1, eval_metric="acc", arg_params={
            "fc_weight": mx.nd.array(w0, ctx=ctx),
            "fc_bias": mx.nd.zeros((2,), ctx=ctx)}, optimizer="sgd",
            optimizer_params=dict(SPARSE19_OPT),
            batch_end_callback=lambda p: stamps.append(
                time.perf_counter()))
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        after = io_plane.stats()
        moved = {k: after[k] - before[k] for k in ("bytes", "batches")}
        return mod, np.diff(stamps), moved

    gmod, gsecs, moved = fit(mx.gpu(0))
    cmod, csecs, _ = fit(mx.cpu())
    bound = gmod._exec_group.execs[0].arg_dict["data"].data
    match = []
    for k in range(cfg["batches"]):
        rows = rows19(ids, vals, B * k, B * (k + 1), F, dev)
        if bound.device.type == dev.type and torch.equal(bound, rows):
            match.append(k)
        del rows
    bound_ok = match == [cfg["batches"] - 1]
    print(f"19a sparse: step and fit times on the card "
          f"{', '.join(f'{t:.3f}' for t in gsecs)} s, on the CPU "
          f"{', '.join(f'{t:.3f}' for t in csecs)} s; the bound input "
          f"equals batch {match} of {cfg['batches']}")
    gsecs, csecs = float(gsecs.sum()), float(csecs.sum())
    gargs, _ = gmod.get_params()
    cargs, _ = cmod.get_params()
    worst = max(op_ratio(gargs[k].asnumpy(), cargs[k].asnumpy(),
                         SPARSE19_TOL) for k in ("fc_weight", "fc_bias"))
    per_batch = moved["bytes"] / max(moved["batches"], 1)
    print(f"19a sparse: Module.fit of FullyConnected(2) + SoftmaxOutput, "
          f"{cfg['batches']} steps at batch {B}: card {gsecs:.2f} s "
          f"(ring: {moved['batches']} batches, {per_batch:.0f} bytes a "
          f"batch crossed, the CSR parts and labels, against "
          f"{B * F * 4} dense), CPU {csecs:.2f} s; the bound input after "
          f"the last step = its rows on the card "
          f"{'bit for bit' if bound_ok else 'FAIL'}; parameters card vs "
          f"CPU at {worst:.3f} of the tolerance (rtol {SPARSE19_TOL[0]:g},"
          f" atol {SPARSE19_TOL[1]:g}*max|ref|) [{card}]")
    check(bound_ok, "19a: the bound input is not the batch's rows")
    check(moved["batches"] >= cfg["batches"] and
          per_batch <= B * cfg["nnz"] * 12 + 8 * (B + 1) + 4 * B,
          "19a: the ring moved more than the CSR parts")
    check(worst <= 1, "19a: 4 steps on the card disagree with the CPU")

    # sparse.dot on the card against the dense product
    w = gargs["fc_weight"].as_in_context(mx.gpu(0))
    gcsr = csr.as_in_context(mx.gpu(0))
    got = sparse.dot(gcsr, w, transpose_b=True).data
    dense = sparse.dense_tensor(csr, dev)
    ref = dense @ w.data.t()
    err, ok = within(got, ref, *SPARSE19_TOL)
    sp_ms = time_ms(lambda: sparse.dot(gcsr, w, transpose_b=True),
                    torch.empty(1, device=dev), iters=10)
    dense_ms = time_ms(lambda: dense @ w.data.t(),
                       torch.empty(1, device=dev), iters=10)
    del dense, ref
    print(f"19a sparse: sparse.dot(csr ({B}, {F}), weight^T) on the card "
          f"max_abs_err {err:.3e} against the dense product "
          f"{'ok' if ok else 'FAIL'}; {sp_ms:.4f} ms against "
          f"{dense_ms:.4f} ms dense (event times)")
    check(ok, "19a: sparse.dot disagrees with the dense product")

    # the touched rows of the weight as row_sparse, through a .params
    touched = np.unique(ids)
    rows = w.data.t()[torch.from_numpy(touched).to(dev)].contiguous()
    rs = sparse.RowSparseNDArray(rows, touched, (F, 2), ctx=mx.gpu(0))
    ppath = os.path.join(tmp, "touched.params")
    mx.nd.save(ppath, {"fc_weight_rows": rs})
    back = mx.nd.load(ppath)["fc_weight_rows"]
    same = isinstance(back, sparse.RowSparseNDArray) and \
        back.shape == (F, 2) and \
        np.array_equal(back._np_indices, touched) and \
        back._np_data.tobytes() == rows.cpu().numpy().tobytes()
    print(f"19a sparse: the weight's {len(touched)} touched rows as "
          f"row_sparse ({os.path.getsize(ppath)} bytes in the .params) "
          f"loaded back {'bit for bit' if same else 'FAIL'}")
    check(same, "19a: the row_sparse round trip differs")
    return {"worst": worst, "bytes_batch": per_batch, "dot_ms": sp_ms,
            "dense_dot_ms": dense_ms, "card_s": gsecs}


def resnet19_params(sym, shape, rng):
    """He-scaled convolution and dense weights, BatchNorm at gamma 1,
    beta 0 and seeded running statistics."""
    shapes, _, aux_shapes = sym.infer_shape(data=shape)
    args = {}
    for name, s in zip(sym.list_arguments(), shapes):
        if name == "data":
            continue
        if name.endswith(("_bias", "_beta")):
            args[name] = np.zeros(s, np.float32)
        elif name.endswith("_gamma"):
            args[name] = np.ones(s, np.float32)
        else:
            args[name] = (rng.standard_normal(s) * math.sqrt(
                2.0 / int(np.prod(s[1:])))).astype(np.float32)
    auxs = {}
    for name, s in zip(sym.list_auxiliary_states(), aux_shapes):
        auxs[name] = (rng.uniform(0.5, 2.0, s) if name.endswith("var")
                      else rng.normal(0, 0.1, s)).astype(np.float32)
    return args, auxs


def eval19(mx, sym, args, auxs, x, device):
    """One inference forward of `sym` on `device` (the graph interpreter,
    no partitioning); the first output as a numpy array."""
    fn, arg_nodes, aux_nodes = mx.sym.graph_eval_fn(sym, False)
    feed = {k: torch.as_tensor(np.asarray(v.asnumpy() if hasattr(
        v, "asnumpy") else v)).to(device) for k, v in args.items()}
    feed["data"] = torch.from_numpy(x).to(device)
    aux = [torch.as_tensor(np.asarray(auxs[n.name].asnumpy() if hasattr(
        auxs[n.name], "asnumpy") else auxs[n.name])).to(device)
        for n in aux_nodes]
    with torch.inference_mode():
        outs, _ = fn([feed[n.name] for n in arg_nodes], aux)
    return [o.cpu().numpy() for o in outs]


def serve19(mx, name, sym, args, auxs, tmp, reqs):
    """Partition `sym` with TPU_PALLAS, save the pair, serve it through
    ModelServer at BUCKETS on the card, ask `reqs` one at a time; ->
    (answers, K1 launches, batches, images/s at bucket 32)."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    part = mx.subgraph.partition_graph(sym, "TPU_PALLAS")
    fused = [n["op"] for n in json.loads(part.tojson())["nodes"]
             ].count("_sg_pallas_fc_relu")
    check(fused == 2, f"{name}: TPU_PALLAS fused {fused} FC+ReLU chains")
    prefix = os.path.join(tmp, name)
    mx.save_checkpoint(prefix, 0, part, args, auxs)
    srv = mx.serving.ModelServer(max_queue_latency_ms=2.0, ctx=mx.gpu(0))
    fc_relu.launches = 0
    srv.load_model(name, prefix=prefix, epoch=0,
                   data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
    got = [srv.predict(name, {"data": x}, timeout_ms=600_000)[0].asnumpy()
           for x in reqs]
    launches = fc_relu.launches
    batches = srv.stats()[name]["batches"]
    model = srv.model(name)
    arrs = [np.zeros((32,) + IMAGE, np.float32)]
    for _ in range(RATE19["warm"]):
        model.run_bucket(arrs, 32)
    model.synchronize()
    t0 = time.perf_counter()
    for _ in range(RATE19["timed"]):
        model.run_bucket(arrs, 32)
    model.synchronize()
    rate = 32 * RATE19["timed"] / (time.perf_counter() - t0)
    srv.shutdown(drain=True)
    expect = 2 * (len(BUCKETS) + batches)
    check(batches == len(reqs) and launches == expect,
          f"{name}: {batches} batches for {len(reqs)} requests, K1 "
          f"{launches} launches, want {expect}")
    return got, launches, batches, rate


def onnx19(mx, card, tmp, sym, params, reqs):
    """19b: VGG-16 exported, imported, served; ResNet-50 v1 round trip."""
    from incubator_mxnet_tpu_torch.contrib import onnx
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    path = os.path.join(tmp, "vgg16.onnx")
    nd_params = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in params.items()}
    t0 = time.perf_counter()
    onnx.export_model(sym, nd_params, in_shapes=[(1,) + IMAGE],
                      onnx_file_path=path)
    export_s = time.perf_counter() - t0
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    isym, iargs, iauxs = onnx.import_model(path)
    import_s = time.perf_counter() - t0
    same = sorted(iargs) == sorted(params) and not iauxs and all(
        iargs[k].asnumpy().tobytes() == v.tobytes()
        for k, v in params.items())
    check(same, "19b: the imported parameters differ from the exported")
    got, launches, batches, rate = serve19(mx, "vgg16_onnx", isym, iargs,
                                           iauxs, tmp, reqs)
    dev = torch.device(DEV19)
    worst = 0.0
    refs = []
    for x, g in zip(reqs, got):
        ref = eval19(mx, sym, params, {}, x, dev)[0]
        refs.append(ref)
        check(g.shape == (len(x), CLASSES) and np.isfinite(g).all(),
              f"19b: answer shape {g.shape} or non-finite values")
        err, ok = within(torch.from_numpy(g), torch.from_numpy(ref),
                         *SERVE_TOL)
        worst = max(worst, err)
        check(ok, f"19b: the served ONNX VGG-16 disagrees with the "
                  f"original (max abs err {err:.3e})")
    print(f"19b onnx: VGG-16 exported in {export_s:.2f} s ({size} bytes, "
          f"opset 13), imported in {import_s:.2f} s, the parameters bit "
          f"for bit; served from the checkpoint pair under TPU_PALLAS: "
          f"{len(reqs)} requests of {sum(len(x) for x in reqs)} images, K1 "
          f"{launches} launches = 2 x ({len(BUCKETS)} warm-up + {batches} "
          f"batches); answers vs the original symbol on the card, "
          f"max_abs_err {worst:.3e} (rtol {SERVE_TOL[0]:g}, atol "
          f"{SERVE_TOL[1]:g}*max|ref|); bucket 32 {rate:.1f} images/s "
          f"[{card}]")

    # ResNet-50 v1 (BatchNorm, the residual adds, global pooling)
    net = mx.gluon.model_zoo.vision.resnet50_v1(classes=CLASSES,
                                                prefix="rn19_")
    rsym = unique_names(mx, net(mx.sym.Variable("data")), "rn19_")
    rng = np.random.RandomState(SEED + 21)
    shape = (RESNET19_BATCH,) + IMAGE
    rargs, rauxs = resnet19_params(rsym, shape, rng)
    rpath = os.path.join(tmp, "resnet50.onnx")
    t0 = time.perf_counter()
    onnx.export_model(rsym, {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in
                             {**rargs, **rauxs}.items()},
                      in_shapes=[shape], onnx_file_path=rpath)
    rsym2, rargs2, rauxs2 = onnx.import_model(rpath)
    rt_s = time.perf_counter() - t0
    x = rng.rand(*shape).astype(np.float32)
    ref = eval19(mx, rsym, rargs, rauxs, x, dev)[0]
    part = mx.subgraph.partition_graph(rsym2, "TPU_PALLAS")
    fc_relu.launches = 0
    out = eval19(mx, part, rargs2, rauxs2, x, dev)[0]
    rn_launches = fc_relu.launches
    ratio = op_ratio(out, ref, ROUNDTRIP19_TOL)
    ok = out.shape == ref.shape and np.isfinite(out).all() and \
        ratio <= 1 and rn_launches == 0 and set(rauxs2) == set(rauxs)
    print(f"19b onnx: ResNet-50 v1 ({len(rauxs)} BatchNorm statistics) "
          f"exported and imported in {rt_s:.2f} s "
          f"({os.path.getsize(rpath)} bytes); forward at batch "
          f"{RESNET19_BATCH} on the card vs the original at {ratio:.4f} of "
          f"the tolerance (rtol {ROUNDTRIP19_TOL[0]:g}, atol "
          f"{ROUNDTRIP19_TOL[1]:g}*max|ref|), K1 {rn_launches} launches "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, "19b: the ResNet-50 round trip disagrees with the original")
    return {"launches": launches, "batches": batches, "worst": worst,
            "rate": rate, "export_s": export_s, "import_s": import_s,
            "bytes": size, "refs": refs, "resnet": ratio}


def int8_fc_routes(card):
    """19c: the int8 FC route (float64 GEMM) at fc8's K and N for the
    served rows against the exact integer product, beside an fp32 GEMM
    of the same operands and `torch._int_mm` where it takes the shape."""
    from incubator_mxnet_tpu_torch.ops.quantization import _int_dot
    dev = torch.device(DEV19)
    rng = np.random.RandomState(SEED + 22)
    w = torch.from_numpy(rng.randint(-127, 128, (CLASSES, 4096)).astype(
        np.int8)).to(dev)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    lines = []
    for m in INT8_FC_ROWS:
        x = torch.from_numpy(rng.randint(-127, 128, (m, 4096)).astype(
            np.int8)).to(dev)
        exact = x.cpu().long() @ w.cpu().long().t()
        got = _int_dot(x, w)
        ok = torch.equal(got.cpu().long(), exact)
        fp32 = (x.float() @ w.float().t()).cpu().double()
        fp32_off = int((fp32 != exact.double()).sum())
        ms = time_ms(lambda: _int_dot(x, w), flush, iters=10)
        f32_ms = time_ms(lambda: x.float() @ w.float().t(), flush, iters=10)
        try:
            im = torch._int_mm(x, w.t())
            im_ok = torch.equal(im.cpu().long(), exact)
            im_ms = time_ms(lambda: torch._int_mm(x, w.t()), flush,
                            iters=10)
            im_txt = f"_int_mm {im_ms:.4f} ms ({'exact' if im_ok else 'WRONG'})"
        except RuntimeError as e:
            im_txt = f"_int_mm refuses ({str(e).splitlines()[0][:60]})"
        lines.append((m, ok, ms))
        print(f"19c int8 fc route: M={m} K=4096 N={CLASSES}: float64 GEMM "
              f"{'exact' if ok else 'FAIL'} {ms:.4f} ms; fp32 GEMM "
              f"{f32_ms:.4f} ms, {fp32_off} sums off; {im_txt} [{card}]")
        check(ok, f"19c: the int8 FC route is not exact at M={m}")
    return lines


def int8_19(mx, card, tmp, sym, params, reqs, fp32_refs):
    """19c: VGG-16 quantized (naive calibration, fc6/fc7 excluded),
    served; held to the CPU's int8 graph."""
    from incubator_mxnet_tpu_torch.contrib.quantization import (
        quantize_model)
    rng = np.random.RandomState(SEED + 23)
    calib = mx.io.NDArrayIter(rng.rand(CALIB19["images"], *IMAGE).astype(
        np.float32), batch_size=CALIB19["batch"])
    gparams = {k: mx.nd.array(v, ctx=mx.gpu(0)) for k, v in params.items()}
    excluded = ["vgg0_dense0_fwd", "vgg0_dense1_fwd"]
    t0 = time.perf_counter()
    qsym, qargs, qauxs = quantize_model(
        sym, gparams, {}, ctx=mx.gpu(0), excluded_sym_names=excluded,
        calib_mode="naive", calib_data=calib,
        num_calib_examples=CALIB19["images"])
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    ops = [n["op"] for n in json.loads(qsym.tojson())["nodes"]]
    counts = {op: ops.count(op) for op in (
        "_contrib_quantized_conv", "_contrib_quantized_pooling",
        "_contrib_quantized_fully_connected", "FullyConnected",
        "Convolution", "Pooling")}
    check(counts == {"_contrib_quantized_conv": 13,
                     "_contrib_quantized_pooling": 5,
                     "_contrib_quantized_fully_connected": 1,
                     "FullyConnected": 2, "Convolution": 0, "Pooling": 0},
          f"19c: the quantized graph holds {counts}")
    check(all(qargs[f"vgg0_conv2d{i}_weight"].asnumpy().dtype == np.int8
              for i in range(13)) and
          qargs["vgg0_dense2_weight"].asnumpy().dtype == np.int8 and
          qargs["vgg0_dense0_weight"].asnumpy().dtype == np.float32,
          "19c: the weights are not int8 where quantized")
    print(f"19c int8: quantize_model(calib_mode='naive') over "
          f"{CALIB19['images']} images at batch {CALIB19['batch']} on the "
          f"card in {calib_s:.2f} s: 13 convolutions, 5 poolings and fc8 "
          f"int8, fc6/fc7 excluded (FullyConnected -> ReLU) [{card}]")
    host = {k: v.as_in_context(mx.cpu()) for k, v in qargs.items()}
    got, launches, batches, rate = serve19(mx, "vgg16_int8", qsym, host,
                                           {}, tmp, reqs)
    # the CPU's int8 graph on the same images; the input of fc8's
    # quantize_v2, to find the values that sit at a .5 of its step
    js = json.loads(qsym.tojson())
    names = [n["name"] for n in js["nodes"]]
    fc8 = next(n for n in js["nodes"]
               if n["op"] == "_contrib_quantized_fully_connected")
    qv2 = js["nodes"][fc8["inputs"][0][0]]
    src = names[qv2["inputs"][0][0]]
    scale = max(abs(float(qv2["attrs"]["min_calib_range"])),
                abs(float(qv2["attrs"]["max_calib_range"])))
    probe = mx.sym.Group([qsym.get_internals()[f"{src}_output"], qsym])
    wq = host["vgg0_dense2_weight"].asnumpy().astype(np.float64)
    wmax = float(host["vgg0_dense2_weight_max"].asnumpy()[0])
    step = (np.float32(scale) / np.float32(127.0)) * \
        (np.float32(wmax) / np.float32(127.0))
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    ties = flipped_rows = 0
    worst = 0.0
    cpu_out = []
    for x, g in zip(reqs, got):
        pre, out = eval19(mx, probe, host, {}, x, cpu)
        cpu_out.append(out)
        v = (torch.from_numpy(pre) / torch.tensor(scale, dtype=torch.float32)
             * 127.0).numpy().reshape(len(x), -1)
        near = np.abs(v - np.floor(v) - 0.5) < INT8_TIE
        ties += int(near.sum())
        excuse = (near.astype(np.float64) @ np.abs(wq).T) * float(step)
        diff = np.abs(g.astype(np.float64) - out)
        slack = 1e-6 * np.abs(out).max()
        flipped_rows += int((diff > slack).any(axis=1).sum())
        worst = max(worst, float((diff / (excuse * (1 + 1e-6) + slack)).max()))
    cpu_s = time.perf_counter() - t0
    ok = worst <= 1 and all(g.shape == (len(x), CLASSES) and
                            np.isfinite(g).all() for g, x in zip(got, reqs))
    print(f"19c int8: served from the checkpoint pair under TPU_PALLAS: "
          f"{len(reqs)} requests, K1 {launches} launches = 2 x "
          f"({len(BUCKETS)} warm-up + {batches} batches) at fc6 (M, 25088 "
          f"-> 4096) and fc7; card vs the CPU's int8 graph ({cpu_s:.1f} s "
          f"on the CPU): {ties} of fc8's inputs within {INT8_TIE:g} of a .5 "
          f"step (may round either way: K1 and the CPU sum fc7 in other "
          f"orders), {flipped_rows} rows differ, worst {worst:.3f} of what "
          f"flipping them all could move (+ 1e-6*max|ref|) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "19c: the card's int8 graph disagrees with the CPU's "
              "beyond its .5 ties")
    # where the two devices part inside the graph: every int8 activation
    # and int32 accumulator of one request, free running
    layer_ops = ("_contrib_quantize_v2", "_contrib_quantized_conv",
                 "_contrib_quantized_pooling",
                 "_contrib_quantized_fully_connected")
    picks = [f"{n['name']}_output0" for n in js["nodes"]
             if n["op"] in layer_ops]
    group = mx.sym.Group([qsym.get_internals()[k] for k in picks])
    x = reqs[1]
    on_card = eval19(mx, group, host, {}, x, torch.device(DEV19))
    on_cpu = eval19(mx, group, host, {}, x, cpu)
    parted = [(k, int((a != b).sum()), a.size)
              for k, a, b in zip(picks, on_card, on_cpu)]
    first = next((k for k, d, _ in parted if d), None)
    print(f"19c int8: {len(picks)} int8/int32 tensors of a {len(x)}-image "
          f"request, card vs CPU free running: "
          f"{sum(d for _, d, _ in parted)} of "
          f"{sum(n for _, _, n in parted)} elements differ; the first "
          f"tensor that differs: {first} (fc8's quantize is "
          f"{qv2['name']})")
    allg = np.concatenate(got)
    allf = np.concatenate(fp32_refs)
    rel = float(np.linalg.norm(allg - allf) / np.linalg.norm(allf))
    top1 = float(np.mean(allg.argmax(1) == allf.argmax(1)))
    print(f"19c int8: against the fp32 VGG-16 on the card: logits relative "
          f"L2 {rel:.4f}, top-1 agreement {top1:.4f} over "
          f"{len(allg)} images; bucket 32 {rate:.1f} images/s [{card}]")
    return {"launches": launches, "batches": batches, "worst": worst,
            "ties": ties, "rate": rate, "calib_s": calib_s, "rel": rel,
            "top1": top1}


def slice17_phase(card, workdir):
    """Phase 19; returns K1's launches on its two serving paths and the
    numbers of the summary line.  K2 and K3 must not run."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    vgg_k1_held("phase 19")
    for wrapper in (flash_fwd, flash_fwd_stream):
        wrapper.launches = 0
    out, times = {}, {}
    tmp = tempfile.mkdtemp(dir=workdir)
    try:
        t0 = time.perf_counter()
        out["19a"] = sparse19(mx, card, tmp)
        times["19a"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        sym = unique_names(mx, mx.model_zoo.vgg_symbol(16, classes=CLASSES),
                           "vgg0_")
        params = vgg_params(sym, np.random.RandomState(SEED + 19))
        rng = np.random.RandomState(SEED + 24)
        reqs = [rng.rand(r, *IMAGE).astype(np.float32) for r in
                SERVE19_SIZES]
        out["19b"] = onnx19(mx, card, tmp, sym, params, reqs)
        times["19b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["routes"] = int8_fc_routes(card)
        out["19c"] = int8_19(mx, card, tmp, sym, params, reqs,
                             out["19b"].pop("refs"))
        times["19c"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for key, secs in times.items():
        print(f"phase {key}: {secs:.1f} s")
    check([flash_fwd.launches, flash_fwd_stream.launches] == [0, 0],
          "phase 19: K2/K3 ran")
    out["times"] = times
    out["k1"] = {"onnx_serving": out["19b"]["launches"],
                 "int8_serving": out["19c"]["launches"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- phase 20: the serving fleet (slice 18) ----------------------------------

# 20a: 4 client threads x 40 requests of 1-4 images over 12 seeded inputs,
# the classes in turn; one worker SIGKILLed after the 40th accepted request
VGG20 = dict(clients=4, requests=40, rows=(1, 2, 3, 4), inputs=12,
             kill_after=40)
SWAP20_CLIENTS = 2        # 20b: client threads running through the roll
# 20c: the autoscaler's windows shortened through its constructor; the SLO
# is 3x a lone 4-image request's round trip to a worker (20a), the ramp
# 8 clients of 4 images, then 2 clients of 1 image (the dead band)
FLEET20 = dict(min=1, max=3, tick=0.2, up_after=1.0, down_after=2.0,
               cooldown=1.0, heartbeat=0.25, deadline=2.0, slo_x=3.0,
               ramp=(8, 4), light=(2, 1))
DECODE20 = dict(seqs=12, new=8, slots=4, prompt=(4, 8))   # 20d
# 20e: 4 clients x 25 requests of 64 samples; shard 1 SIGKILLed after the
# 30th accepted request
EMBED20 = dict(clients=4, requests=25, kill_after=30)
CTX20 = "gpu"             # the workers' --ctx (a CPU rehearsal: "cpu")
K1_COUNTED20 = True       # workers count K1 (a CPU rehearsal's count none)
# the workers' fp32 as this process's (TF32 off in cuBLAS and cuDNN), and a
# dead peer's socket diagnosed in ~0.5 s instead of the 5 s default
ENV20 = {"NVIDIA_TF32_OVERRIDE": "0"}
KNOBS20 = {"MXNET_PS_RECONNECT_WAIT": "0.5", "MXNET_PS_MAX_RETRIES": "2",
           "MXNET_PS_REQUEST_TIMEOUT": "60"}


def quiesce20(router):
    """Park the router's health loop (an hour's interval) and wait out a
    sweep in progress, so K1's counter and the replicas' batch and probe
    counts can be read together."""
    router.health_interval_s = 3600.0
    time.sleep(3 * 0.2 + 0.3)


def local_k1_20(reps, base):
    """K1 launches the in-process replicas `reps` owe since `base` (their
    (batches, probes) then): 2 a served batch and 2 a deepcheck."""
    owed = 0
    for r in reps:
        b0, p0 = base[r.replica_id]
        owed += 2 * (r.stats()["batches"] - b0 + r.probes - p0)
    return owed


def worker_k1_20(st, what):
    """A worker's stats: its K1 launches are 2 a forward (its ladder's
    warm-up, each executed request and each deepcheck); -> launches."""
    k1 = st["cache"]["k1_launches"]
    owed = 2 * (st["programs"] + st["executed"] + st["probes"])
    check(not K1_COUNTED20 or k1 == owed,
          f"{what}: worker K1 launches {k1}, expected 2 x ({st['programs']}"
          f" warm-up + {st['executed']} requests + {st['probes']} "
          f"deepchecks) = {owed}")
    check(st["cache"]["builds"] == 0, f"{what}: the worker built kernels")
    return k1


def traffic20(router, requests, kill=None, kill_after=None, ask=None):
    """Run `requests` (per client: [(key, inputs, priority)]) through
    `router` (or `ask(inputs, priority, key)`) from one thread per
    client; `kill()` runs once the `kill_after`-th request is accepted.
    -> (answers {key: (outputs, latency s)}, errors, wall s, the kill's
    time.monotonic())."""
    answers, errors = {}, []
    lock = threading.Lock()
    accepted = [0]
    killed = [None]
    gate = threading.Barrier(len(requests) + 1)

    def client(reqs):
        gate.wait()
        for key, inputs, prio in reqs:
            try:
                t = time.perf_counter()
                fut = router.submit(inputs, timeout_ms=600_000,
                                    priority=prio, request_id=key) \
                    if ask is None else ask(inputs, prio, key)
                with lock:
                    accepted[0] += 1
                    if accepted[0] == kill_after and kill is not None:
                        killed[0] = time.monotonic()
                        kill()
                out = fut.result(600)
                answers[key] = (out, time.perf_counter() - t)
            except Exception as exc:   # counted below; fails the run
                errors.append(f"{key}: {exc!r}")

    threads = [threading.Thread(target=client, args=(r,), daemon=True)
               for r in requests]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(900)
    check(not any(t.is_alive() for t in threads), "phase 20: a client hung")
    return answers, errors, time.perf_counter() - t0, killed[0]


def classes20(router):
    """'class: responses at p50/p99' of a router's answered requests."""
    classes = router.stats()["classes"]
    return ", ".join(f"{c} {classes[c]['responses']} at p50 "
                     f"{classes[c]['p50_ms']:.1f} p99 "
                     f"{classes[c]['p99_ms']:.1f} ms"
                     for c in ("interactive", "batch", "best_effort")
                     if c in classes)


def router20(mx, card, tmp):
    """20a and 20b: VGG-16 at full width (phase 4's symbol and seeded
    weights, TPU_PALLAS, buckets 1-32) behind a `ReplicaRouter` over two
    `LocalReplica`s on gpu(0) and two worker processes on the card
    (`RemoteReplica.spawn`); the traffic and one worker's SIGKILL, then a
    rolling swap from an elastic checkpoint under traffic."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch.serving.router import PRIORITIES
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    t0 = time.perf_counter()
    sym = mx.model_zoo.vgg_symbol(16, classes=CLASSES)
    part = mx.subgraph.partition_graph(sym, "TPU_PALLAS")
    params = vgg_params(sym, np.random.RandomState(SEED))
    prefix = os.path.join(tmp, "vgg20")
    mx.save_checkpoint(prefix, 0, part, params, {})
    kw = dict(data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
    remote, errors = [None, None], []
    root = os.path.join(tmp, "vgg20-ckpt")
    second = {}

    def checkpoint():
        """20b's elastic checkpoint of a second seeded weight set, written
        while the workers start and 20a runs."""
        try:
            second["params"] = vgg_params(sym,
                                          np.random.RandomState(SEED + 21))
            mgr = ckpt.CheckpointManager(root, async_snapshots=False)
            mgr.snapshot(arrays={f"arg:{k}": v for k, v in
                                 second["params"].items()}, step=1)
            mgr.close()
        except Exception as exc:
            second["error"] = repr(exc)

    writer = threading.Thread(target=checkpoint, daemon=True)
    writer.start()

    def spawn(i):
        try:
            remote[i] = mx.serving.RemoteReplica.spawn(
                prefix=prefix, epoch=0, name="vgg", replica_id=f"w{i}",
                ctx=CTX20, env=ENV20, ready_timeout=300.0, **kw)
        except Exception as exc:
            errors.append(repr(exc))

    spawners = [threading.Thread(target=spawn, args=(i,)) for i in range(2)]
    for t in spawners:
        t.start()
    out = {}
    router = None
    try:
        local = [mx.serving.LocalReplica(mx.serving.ServedModel.load(
            prefix, 0, ctx=mx.gpu(0), name="vgg", **kw),
            replica_id=f"l{i}") for i in range(2)]
        ref = mx.serving.ServedModel.load(prefix, 0, ctx=mx.gpu(0),
                                          name="ref", **kw)
        rng = np.random.RandomState(SEED + 20)
        inputs = [rng.rand(VGG20["rows"][i % len(VGG20["rows"])], *IMAGE)
                  .astype(np.float32) for i in range(VGG20["inputs"])]
        old = [ref.infer({"data": x})[0].data for x in inputs]
        for t in spawners:
            t.join()
        check(not errors, f"20a: a worker did not start: {errors}")
        spin = time.perf_counter() - t0
        loads = [(r.ready_info.get("load_ms"), r.ready_info.get("warmup_ms"))
                 for r in remote]
        for r in remote:
            check(r.ready_info.get("builds") == 0 and
                  r.ready_info.get("programs") == len(BUCKETS),
                  f"20a: worker {r.replica_id} READY {r.ready_info}, "
                  f"want programs={len(BUCKETS)} builds=0")
        pre = {r.replica_id: worker_k1_20(r.stats(), f"20a {r.replica_id}")
               for r in remote}
        solo = []
        for _ in range(6):
            t = time.perf_counter()
            remote[0].submit({"data": inputs[3]}).result(60)
            solo.append((time.perf_counter() - t) * 1e3)
        out["solo_ms"] = statistics.median(solo[1:])
        print(f"20a: 2 workers READY programs={len(BUCKETS)} builds=0 "
              f"(K1 {sorted(pre.values())} in their warm-ups; load, "
              f"warm-up ms {loads}) and 2 local replicas in {spin:.1f} s; "
              f"a lone 4-image request to a worker {out['solo_ms']:.2f} ms "
              f"[{card}]")
        router = mx.serving.ReplicaRouter(
            local + remote, name="vgg20", health_interval_s=0.2,
            health_deadline_s=3.0,
            shed_ms={c: 600_000.0 for c in PRIORITIES})
        n = VGG20["clients"] * VGG20["requests"]
        reqs = [[(f"a{c * VGG20['requests'] + i}",
                  {"data": inputs[(c * VGG20["requests"] + i)
                                  % len(inputs)]},
                  PRIORITIES[(c * VGG20["requests"] + i) % 3])
                 for i in range(VGG20["requests"])]
                for c in range(VGG20["clients"])]
        base = {r.replica_id: (r.stats()["batches"], r.probes)
                for r in local}
        fc_relu.launches = 0
        lost_at = []

        def watch():
            end = time.monotonic() + 600
            while router.replicas_lost == 0 and time.monotonic() < end:
                time.sleep(0.002)
            lost_at.append(time.monotonic())

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        answers, errs, wall, t_kill = traffic20(
            router, reqs, kill=remote[1].kill, kill_after=VGG20["kill_after"])
        quiesce20(router)
        k1_local = fc_relu.launches
        owed = local_k1_20(local, base)
        watcher.join(30)
        check(not errs, f"20a: requests failed: {errs[:3]}")
        check(len(answers) == n, f"20a: {len(answers)} of {n} answered")
        st = router.stats()
        check(st["replicas_lost"] == 1, f"20a: replicas_lost "
              f"{st['replicas_lost']}, want 1")
        check(st["duplicates_suppressed"] == 0, "20a: a duplicate answer")
        check(remote[1].process.wait(30) == -signal.SIGKILL,
              "20a: w1 was not SIGKILLed")
        wst = remote[0].stats()
        rids = list(wst["executed_rids"]) + [
            rid for r in local for rid in r.executed_rids]
        check(len(rids) == len(set(rids)),
              "20a: a request id executed twice among the survivors")
        worst = 0.0
        rtol, atol = SERVE_TOL
        for key, (outs, _) in answers.items():
            got = outs[0].data.cpu()
            want = old[int(key[1:]) % len(inputs)].cpu()
            check(got.shape == want.shape and
                  bool(torch.isfinite(got).all()),
                  f"20a: answer {key} shape {tuple(got.shape)}")
            err, ok = within(got, want, rtol, atol)
            worst = max(worst, err)
            check(ok, f"20a: answer {key} disagrees with the in-process "
                      f"model (max abs err {err:.3e})")
        check(k1_local == owed, f"20a: in-process K1 launches {k1_local}, "
              f"expected 2 a served batch and deepcheck = {owed}")
        k1_w0 = worker_k1_20(wst, "20a w0")
        images = sum(len(inputs[int(k[1:]) % len(inputs)]) for k in answers)
        per = {r.replica_id: r.stats()["batches"] - base[r.replica_id][0]
               for r in local}
        out["20a"] = {"rps": n / wall, "images_s": images / wall,
                      "failover_s": lost_at[0] - t_kill,
                      "failovers": st["failovers"], "worst": worst,
                      "classes": st["classes"]}
        print(f"20a: {n} requests ({images} images) from "
              f"{VGG20['clients']} clients in {wall:.2f} s: "
              f"{out['20a']['rps']:.1f} requests/s, "
              f"{out['20a']['images_s']:.1f} images/s; {classes20(router)}"
              f"; w1 SIGKILLed after the {VGG20['kill_after']}th: declared "
              f"dead {out['20a']['failover_s']:.3f} s later, "
              f"{st['failovers']} failovers, 0 lost, no rid twice; answers "
              f"vs the in-process model worst {worst:.3e}; local batches "
              f"{per} (K1 {k1_local} = 2 a batch and deepcheck), w0 "
              f"{wst['executed']} requests (K1 {k1_w0}) [{card}]")
        out["k1_local"] = k1_local
        out["k1_workers"] = k1_w0 + pre["w1"]
        # 21a's key: who executed each answered request, and the pids
        by = {rid: "w0" for rid in wst["executed_rids"] if rid in answers}
        for r in local:
            by.update({rid: r.replica_id for rid in r.executed_rids
                       if rid in answers})
        out["spans21"] = {
            "answered": sorted(answers), "by": by,
            "pids": {"main": os.getpid(), "w0": remote[0].process.pid,
                     "w1": remote[1].process.pid},
            "failovers": st["failovers"]}

        # 20b: the rolling swap over the N-1 fleet, under traffic
        t0 = time.perf_counter()
        router.health_interval_s = 0.2
        writer.join()
        check("error" not in second, f"20b: the checkpoint: {second}")
        ref.set_params(second.pop("params"))
        new = [ref.infer({"data": x})[0].data for x in inputs]
        for a, b in zip(old, new):
            check(not within(b.cpu(), a.cpu(), rtol, atol)[1],
                  "20b: the two weight sets answer alike")
        programs = [r._model.program_count() for r in local]
        base = {r.replica_id: (r.stats()["batches"], r.probes)
                for r in local}
        fc_relu.launches = 0
        stop = threading.Event()
        seen, errs = [], []

        def client(c):
            i = 0
            while not stop.is_set():
                key = f"b{c}-{i}"
                try:
                    seen.append((i % len(inputs), router.predict(
                        {"data": inputs[i % len(inputs)]},
                        timeout_ms=600_000, request_id=key)[0].data))
                except Exception as exc:
                    errs.append(f"{key}: {exc!r}")
                i += 1

        clients = [threading.Thread(target=client, args=(c,), daemon=True)
                   for c in range(SWAP20_CLIENTS)]
        # w0's swap and the deepcheck after it, timed on the router's
        # side: both wait on the swap's budget, not the 5 s control
        # timeout of the health loop
        w0_ms = {}

        def timed(name, fn):
            def call(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    if name == "swap" or k.get("timeout_s") is not None:
                        w0_ms[name] = (time.perf_counter() - t) * 1e3
            return call

        remote[0].swap = timed("swap", remote[0].swap)
        remote[0].probe = timed("deepcheck", remote[0].probe)
        for t in clients:
            t.start()
        t_swap = time.perf_counter()
        result = router.swap_weights(checkpoint_dir=root)
        swap_s = time.perf_counter() - t_swap
        time.sleep(0.5)
        stop.set()
        for t in clients:
            t.join(120)
        check(not errs, f"20b: requests dropped during the roll: {errs[:3]}")
        check(sorted(result["swapped"]) == ["l0", "l1", "w0"],
              f"20b: swapped {result['swapped']}, want every survivor")
        versions = [0, 0]
        for i, got in seen:
            got = got.cpu()
            hits = [within(got, ref_[i].cpu(), rtol, atol)[1]
                    for ref_ in (old, new)]
            check(any(hits), "20b: an answer is neither version's")
            versions[hits.index(True)] += 1
        check(versions[1] > 0, "20b: no answer at the new version")
        quiesce20(router)
        k1_swap = fc_relu.launches
        check(k1_swap == local_k1_20(local, base),
              f"20b: in-process K1 launches {k1_swap}, expected 2 a batch "
              "and deepcheck")
        wst = remote[0].stats()
        check([r._model.program_count() for r in local] == programs and
              wst["programs"] == len(BUCKETS) and wst["version"] == 1,
              "20b: the swap changed a ladder or missed a worker")
        k1_w0b = worker_k1_20(wst, "20b w0")
        out["20b"] = {"swap_s": swap_s, "answers": len(seen),
                      "versions": versions, "w0_ms": w0_ms}
        out["k1_local"] += k1_swap
        out["k1_workers"] += k1_w0b - k1_w0
        print(f"20b: swap_weights(checkpoint_dir=) over l0, l1, w0 in "
              f"{swap_s:.2f} s under {SWAP20_CLIENTS} clients: "
              f"{len(seen)} answers, {versions[0]} old and {versions[1]} "
              f"new, none mixed, none dropped; w0's swap "
              f"{w0_ms.get('swap', float('nan')):.1f} ms and its deepcheck "
              f"{w0_ms.get('deepcheck', float('nan')):.1f} ms; ladders "
              f"{programs} and {wst['programs']} unchanged, worker builds 0"
              f" [{card}]")
    finally:
        if router is not None:
            router.shutdown(drain=False)
        for r in remote:
            if r is not None and r.process.poll() is None:
                r.process.kill()
                r.process.wait(30)
        writer.join()
    return out


def hosts20(mx):
    """Start 20c's two host daemons (`AgentHost.launch_local`, each in its
    own session) in a thread: -> (the thread, [hosts], [errors])."""
    hosts, errors = [None, None], []

    def launch():
        def one(i):
            try:
                hosts[i] = mx.serving.AgentHost.launch_local(
                    f"host-{i}", env=ENV20, ctx=CTX20)
            except Exception as exc:
                errors.append(repr(exc))

        ts = [threading.Thread(target=one, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    thread = threading.Thread(target=launch, daemon=True)
    thread.start()
    return thread, hosts, errors


def kill_hosts20(hosts):
    for h in hosts:
        if h is not None:
            try:
                os.killpg(h.process.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            h.process.wait(30)


def fleet20(mx, card, hosts, prefix, solo_ms):
    """20c: a `FleetManager` over two `AgentHost`s (two `hostd` processes
    on this machine, each in its own session) serving 20a's VGG-16 on the
    card: a load ramp spawns a second replica on the emptier host, one
    host's process group is SIGKILLed, the survivor backfills, idleness
    retires a replica through the drain."""
    from incubator_mxnet_tpu_torch.serving import fleet as _fleet
    f = FLEET20
    _fleet.reset_findings()
    fm = None
    out = {}
    try:
        slo = f["slo_x"] * solo_ms
        spec = mx.serving.ReplicaSpec(
            data_shapes=[("data", (1,) + IMAGE)], name="vgg", prefix=prefix,
            epoch=0, buckets=BUCKETS, env=ENV20)
        t0 = time.perf_counter()
        fm = mx.serving.FleetManager(
            hosts, spec, name="vgg20", target_replicas=f["min"],
            min_replicas=f["min"], max_replicas=f["max"], slo_ms=slo,
            tick_s=f["tick"], up_after_s=f["up_after"],
            down_after_s=f["down_after"], cooldown_s=f["cooldown"],
            host_heartbeat_s=f["heartbeat"],
            host_deadline_s=f["deadline"])
        print(f"20c: the first replica ({fm.stats()['placement']}) in "
              f"{time.perf_counter() - t0:.1f} s; SLO {slo:.2f} ms "
              f"({f['slo_x']:g} x a lone request)")
        rng = np.random.RandomState(SEED + 22)
        xs = {r: rng.rand(r, *IMAGE).astype(np.float32)
              for r in (f["ramp"][1], f["light"][1])}
        stop = {"ramp": threading.Event(), "light": threading.Event()}
        tally = {"admitted": 0, "answered": 0, "shed": 0}
        errs = []
        lock = threading.Lock()

        def client(kind, rows):
            while not stop[kind].is_set():
                try:
                    fut = fm.router.submit({"data": xs[rows]},
                                           timeout_ms=600_000)
                except Exception as exc:
                    with lock:
                        if "shed threshold" in str(exc):
                            tally["shed"] += 1
                        else:
                            errs.append(f"submit: {exc!r}")
                    time.sleep(0.01)
                    continue
                with lock:
                    tally["admitted"] += 1
                try:
                    fut.result(600)
                    with lock:
                        tally["answered"] += 1
                except Exception as exc:
                    errs.append(f"lost: {exc!r}")

        def start(kind):
            n, rows = f[kind]
            ts = [threading.Thread(target=client, args=(kind, rows),
                                   daemon=True) for _ in range(n)]
            for t in ts:
                t.start()
            return ts

        def wait_for(pred, what, timeout=180.0):
            end = time.monotonic() + timeout
            while not pred():
                check(time.monotonic() < end, f"20c: {what} timed out")
                time.sleep(0.02)

        t_ramp = time.perf_counter()
        ramp = start("ramp")
        wait_for(lambda: fm.stats()["live_replicas"] >= 2,
                 "the ramp's scale-up")
        up_s = time.perf_counter() - t_ramp
        light = start("light")
        stop["ramp"].set()
        for t in ramp:
            t.join(600)
        placed = fm.stats()["placement"]
        on_dead = [rid for rid, h in placed.items() if h == "host-1"]
        check(on_dead, f"20c: the scale-up did not land on the emptier "
              f"host: {placed}")
        before = fm.router.replicas_lost
        t_kill = time.monotonic()
        hosts[1].kill()
        wait_for(lambda: fm.stats()["hosts_lost"] == 1, "host death")
        down = [e for e in fm.stats()["events"]
                if e["action"] == "host_down"][-1]
        declared_s = down["t"] - t_kill
        check(declared_s <= f["deadline"] + f["tick"],
              f"20c: host declared dead {declared_s:.3f} s after the kill, "
              f"past the {f['deadline']:g} s deadline + a {f['tick']:g} s "
              f"tick")
        wait_for(lambda: fm.stats()["backfills"] >= 1, "the backfill")
        st = fm.stats()
        check(set(st["placement"].values()) == {"host-0"},
              f"20c: capacity not backfilled on the survivor: "
              f"{st['placement']}")
        check(fm.router.replicas_lost - before >= len(on_dead),
              f"20c: {len(on_dead)} replica(s) on the dead host, "
              f"{fm.router.replicas_lost - before} lost in the router")
        stop["light"].set()
        for t in light:
            t.join(600)
        # 21b: the fleet scraped with host-1 down and the traffic stopped
        # (the idle retire parked meanwhile, so every leg is still placed)
        fm.autoscaler.down_after_s = 3600.0
        out21b = scrape21(fm, card, "host-1", on_dead)
        fm.autoscaler.down_after_s = f["down_after"]
        t_idle = time.perf_counter()
        wait_for(lambda: fm.stats()["scale_downs"] >= 1, "the idle retire")
        idle_s = time.perf_counter() - t_idle
        check(not errs, f"20c: admitted requests lost: {errs[:3]}")
        check(tally["admitted"] == tally["answered"],
              f"20c: {tally['admitted']} admitted, {tally['answered']} "
              "answered")
        st = fm.stats()
        ups = [e for e in st["events"] if e["action"] == "scale_up"]
        check(ups and all(e["spinup_builds"] == 0 for e in ups),
              f"20c: a spawn built kernels: {ups}")
        # the load and warm-up of each replica alive now (READY's ms)
        loads = [(slot.replica.ready_info.get("load_ms"),
                  slot.replica.ready_info.get("warmup_ms"))
                 for slot in fm._router_slots().values()]
        k1 = 0
        for rid, slot in fm._router_slots().items():
            if slot.state != "dead":
                k1 += worker_k1_20(slot.replica.stats(), f"20c {rid}")
        actions = [e["action"] + (f"@{e['host']}" if e.get("host") else "")
                   for e in st["events"]]
        out = {"declared_s": declared_s, "backfill_s":
               st["backfill_latency_s"], "up_s": up_s, "idle_s": idle_s,
               "spinup_s": [e["duration_s"] for e in ups],
               "tally": dict(tally), "actions": actions, "k1": k1,
               "21b": out21b}
        print(f"20c: actions {' -> '.join(actions)}; the ramp's scale-up "
              f"live {up_s:.1f} s after it began; host-1 SIGKILLed, "
              f"declared dead {declared_s:.3f} s later (deadline "
              f"{f['deadline']:g} s, tick {f['tick']:g} s); backfill "
              f"{st['backfill_latency_s']} s; idle retire "
              f"{idle_s:.1f} s; spawns {out['spinup_s']} s, all builds=0 "
              f"(load, warm-up ms of the live ones {loads}); "
              f"{tally['admitted']} interactive admitted, all answered, "
              f"{tally['shed']} shed; K1 {k1} in the live workers [{card}]")
        for finding in _fleet.findings():
            print(f"20c: finding {finding.format()}")
    finally:
        if fm is not None:
            fm.shutdown(drain=False, close_hosts=True)
        kill_hosts20(hosts)
    return out


def decode20(mx, card):
    """20d: two `DecodeReplica`s at phase 9's GPT-2-small widths (fp32,
    seeded weights) under a router; one killed once its slots are
    active: every sequence completes once, each equal to a lone engine's
    greedy tokens (phase 9's static lane through the survivor's programs)
    wherever its chain is clear of near ties."""
    from incubator_mxnet_tpu_torch.llm import LMConfig
    d = DECODE20
    cfg = LMConfig(**LM_CFG)
    values = lm_values(cfg)
    reps = [mx.serving.DecodeReplica(cfg, values, replica_id=f"d{i}",
                                     slots=d["slots"], buckets=LM_BUCKETS,
                                     ctx=mx.gpu(0)) for i in range(2)]
    del values
    rng = np.random.default_rng(SEED + 23)
    trace = [([int(t) for t in rng.integers(
        1, cfg.vocab_size, int(rng.integers(d["prompt"][0],
                                            d["prompt"][1] + 1)))],
              d["new"]) for _ in range(d["seqs"])]
    router = mx.serving.ReplicaRouter(reps, name="decode20",
                                      health_interval_s=0.05,
                                      max_dispatches=4)
    try:
        t0 = time.perf_counter()
        futs = [router.submit({"tokens": p, "max_new_tokens": n},
                              request_id=f"d20-{i}", timeout_ms=600_000)
                for i, (p, n) in enumerate(trace)]
        end = time.monotonic() + 120
        while reps[0].engine.stats()["slots_active"] == 0 and \
                not all(f.done() for f in futs):
            check(time.monotonic() < end, "20d: no slot became active")
            time.sleep(0.002)
        reps[0].kill()
        got = [f.result(600)["tokens"] for f in futs]
        wall = time.perf_counter() - t0
        st = router.stats()
        survivor = reps[1].engine.stats()["executed_rids"]
    finally:
        router.shutdown(drain=False)
    check(st["replicas_lost"] == 1 and st["duplicates_suppressed"] == 0,
          f"20d: replicas_lost {st['replicas_lost']}, duplicates "
          f"{st['duplicates_suppressed']}")
    check([len(g) for g in got] == [n for _, n in trace],
          "20d: a sequence did not complete its budget")
    check(len(survivor) == len(set(survivor)),
          "20d: a sequence ran twice on the survivor")
    static, clear, _, _ = lm_static(mx, reps[1].engine.programs, cfg, trace)
    bad = [i for i, c in enumerate(clear) if c and static[i] != got[i]]
    check(not bad, f"20d: sequences {bad} differ from a lone engine's")
    tied = [i for i, c in enumerate(clear) if not c]
    print(f"20d: {len(trace)} sequences over 2 DecodeReplicas, d0 killed "
          f"with its slots active: all completed in {wall:.2f} s, "
          f"{st['failovers']} failed over and replayed on d1, each rid "
          f"once; {len(trace) - len(tied)} equal a lone engine's greedy "
          f"tokens, {len(tied)} with a near tie in the chain {tied} "
          f"[{card}]")
    del reps
    gc.collect()
    torch.cuda.empty_cache()
    return {"failovers": st["failovers"], "wall_s": wall, "ties": len(tied)}


def shard20():
    """One parameter-server process (`python -m
    incubator_mxnet_tpu_torch.dist.server`) on a free port, in its own
    session: -> (Popen, port)."""
    from incubator_mxnet_tpu_torch.serving.replica import child_env
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "incubator_mxnet_tpu_torch.dist.server"],
        env=child_env({"DMLC_SERVER_ID": "0",
                       "DMLC_PS_ROOT_URI": "127.0.0.1",
                       "DMLC_PS_ROOT_PORT": str(port)}),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        start_new_session=True)
    return proc, port


def embed20(mx, card, tmp, procs):
    """20e: wide_deep's table at its defaults (200 000 x 16 on 2 shard
    server processes, 4096 cache rows on the card) in front of its tower
    (K1 at deep1, (64, 32 -> 32)) served by a router over two
    `LocalReplica`s, through `EmbeddingServingPath`; one shard server
    SIGKILLed mid-traffic, respawned by ``on_shard_lost``
    (`replace_shard` from the table's rows).  `procs`: the shard servers
    (`shard20`), started when phase 20 began."""
    from incubator_mxnet_tpu_torch import embedding as mxembed
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    cfg, e = WD_CFG, EMBED20
    procs = list(procs)       # each shard's server
    spawned = list(procs)     # every one, to stop
    table = router = None
    out = {}
    try:
        table = mxembed.ShardedEmbedding(
            "user_item", cfg["rows"], cfg["dim"],
            [("127.0.0.1", port) for _, port in procs], seed=7,
            cache_rows=cfg["cache_rows"], ctx=mx.gpu(0))
        rows = table.checkpoint_rows()
        sym = mx.subgraph.partition_graph(
            wd_tower(mx, WD_SLOTS * cfg["dim"], 4), "TPU_PALLAS")
        check(sym.tojson().count('"_sg_pallas_fc_relu"') == 1,
              "20e: deep1 is not K1's node")
        shapes, _, _ = sym.infer_shape(emb=(cfg["batch"], 32),
                                       dense=(cfg["batch"], 4))
        rng = np.random.RandomState(SEED + 25)
        params = {n: rng.uniform(-0.3, 0.3, s).astype(np.float32)
                  for n, s in zip(sym.list_arguments(), shapes)
                  if n not in ("emb", "dense", "softmax_label")}
        prefix = os.path.join(tmp, "tower20")
        mx.save_checkpoint(prefix, 0, sym, params, {})
        kw = dict(data_shapes=[("emb", (1, WD_SLOTS * cfg["dim"])),
                               ("dense", (1, 4))],
                  buckets=(cfg["batch"],), ctx=mx.gpu(0), name="tower")
        local = [mx.serving.LocalReplica(mx.serving.ServedModel.load(
            prefix, 0, **kw), replica_id=f"t{i}") for i in range(2)]
        ref = mx.serving.ServedModel.load(prefix, 0, **kw)
        router = mx.serving.ReplicaRouter(local, name="embed20",
                                          health_interval_s=0.2)
        lock = threading.Lock()
        healed = []

        def on_shard_lost(err):
            with lock:
                chan = table._chans[err.server]
                if err.addr != f"{chan.host}:{chan.port}":
                    return True          # another request already healed it
                t = time.monotonic()
                procs[err.server] = shard20()
                spawned.append(procs[err.server])
                table.replace_shard(err.server, "127.0.0.1",
                                    procs[err.server][1], restore=rows)
                healed.append(time.monotonic() - t)
                return True

        path = mxembed.EmbeddingServingPath(table, router, embed_input="emb",
                                            on_shard_lost=on_shard_lost)
        reqs = []
        for c in range(e["clients"]):
            crng = np.random.RandomState(SEED + 30 + c)
            reqs.append([(f"e{c}-{i}",) + wd_clicks(cfg["batch"],
                                                    cfg["rows"], crng)[:2]
                         for i in range(e["requests"])])
        base = {r.replica_id: (r.stats()["batches"], r.probes)
                for r in local}
        fc_relu.launches = 0
        dead = procs[1][0]
        answers, errs, wall, _ = traffic20(
            router, [[(k, (ids, d), "interactive") for k, ids, d in r]
                     for r in reqs],
            kill=dead.kill, kill_after=e["kill_after"],
            ask=lambda inputs, prio, key: path.submit(
                inputs[0], dense={"dense": inputs[1]}, timeout_ms=600_000,
                priority=prio, request_id=key))
        quiesce20(router)
        k1 = fc_relu.launches
        owed = local_k1_20(local, base) // 2
        check(not errs, f"20e: admitted requests lost: {errs[:3]}")
        n = e["clients"] * e["requests"]
        check(len(answers) == n, f"20e: {len(answers)} of {n} answered")
        st = path.stats()
        check(st["shard_failovers"] >= 1 and table.failovers >= 1,
              f"20e: the shard's death went unnoticed ({st['shard_failovers']}"
              f" shard failovers)")
        check(st["requests"] == st["completed"] == n,
              f"20e: {st['requests']} requests, {st['completed']} completed")
        check(dead.wait(30) == -signal.SIGKILL, "20e: shard 1 was not killed")
        worst = 0.0
        for key, ids, d in (q for r in reqs for q in r):
            want = ref.infer({"emb": rows[ids].reshape(len(ids), -1),
                              "dense": d})[0].data.cpu()
            got = answers[key][0][0].data.cpu()
            err, ok = within(got, want, 1e-5, 1e-6)
            worst = max(worst, err)
            check(ok, f"20e: answer {key} disagrees with the in-process "
                      f"tower (max abs err {err:.3e})")
        check(k1 == owed, f"20e: K1 launches {k1}, expected 1 a tower "
              f"forward = {owed}")
        cache = table.stats().get("cache") or {}
        out = {"samples_s": n * cfg["batch"] / wall, "worst": worst,
               "heal_s": healed, "shard_failovers": st["shard_failovers"],
               "k1": k1}
        print(f"20e: {n} requests of {cfg['batch']} samples from "
              f"{e['clients']} clients in {wall:.2f} s "
              f"({out['samples_s']:.1f} samples/s; {classes20(router)}); "
              f"shard 1 SIGKILLed after the {e['kill_after']}th: "
              f"{st['shard_failovers']} shard failovers, respawn + "
              f"replace_shard {[round(h, 3) for h in healed]} s, 0 lost; "
              f"answers vs the in-process tower worst {worst:.3e}; cache "
              f"{json.dumps(cache, default=str)}; K1 {k1} = 1 a tower "
              f"forward [{card}]")
    finally:
        if router is not None:
            router.shutdown(drain=False)
        if table is not None:
            table.close()
        for proc, _ in spawned:
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)
    return out


# -- phase 21: the telemetry plane (slice 19) --------------------------------

# 21d: each lane is CLIENTS closed-loop clients of REQUESTS21 requests of
# phase 4's shape; the lanes run off, on, on, off (one card, in turns)
REQUESTS21 = 8
PROFILE21_BATCHES = 4           # 21c: bucket-32 batches under the profiler


def mxtrace_tool():
    """tools/mxtrace.py, the repo's merge tool (it imports no JAX)."""
    tools = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tools")
    if tools not in sys.path:
        sys.path.insert(0, tools)
    import mxtrace
    return mxtrace


def scrape21(fm, card, dead, on_dead):
    """21b: `FleetManager.scrape()` while host `dead` is down: it must not
    raise, must list the host and the replicas that were on it under
    ``unreachable``; the survivors' ``worker.executed`` must equal their
    stats() counts, every ``prom`` text must parse, and each survivor's
    K1 count must be 2 a forward (phase 20's rule)."""
    from incubator_mxnet_tpu_torch.obs import parse_prometheus
    t0 = time.perf_counter()
    snap = fm.scrape()
    ms = (time.perf_counter() - t0) * 1e3
    gone = [u for u in [f"host:{dead}"] + [f"replica:{r}" for r in on_dead]
            if u not in snap["unreachable"]]
    check(not gone, f"21b: {gone} not under unreachable: "
          f"{snap['unreachable']}")
    check(snap["replicas"], "21b: no live worker answered the scrape")
    series = 0
    for text in [snap["local"]["prom"]] + [
            leg["prom"] for leg in list(snap["hosts"].values())
            + list(snap["replicas"].values())]:
        series += len(parse_prometheus(text))
    slots = fm._router_slots()
    scraped = stated = k1 = 0
    for rid, leg in snap["replicas"].items():
        st = slots[rid].replica.stats()
        scraped += leg["values"]["worker.executed"]
        stated += st["executed"]
        k1 += worker_k1_20(st, f"21b {rid}")
    check(scraped == stated, f"21b: the survivors' worker.executed sum "
          f"{scraped}, their stats() {stated}")
    print(f"21b: FleetManager.scrape() with {dead} down in {ms:.1f} ms: "
          f"hosts {sorted(snap['hosts'])}, workers {sorted(snap['replicas'])}"
          f", unreachable {snap['unreachable']}; {series} Prometheus series "
          f"parsed; the survivors' worker.executed {scraped} = their stats()"
          f"; K1 {k1} = 2 a forward in each [{card}]")
    return {"ms": ms, "unreachable": snap["unreachable"],
            "replicas": len(snap["replicas"]), "series": series}


def spans21(span_path, info, card):
    """21a: every process of phase 20 appended its spans to `span_path`;
    merged by tools/mxtrace.py: zero orphans; each answered request of
    20a is one ``router.request`` root whose tree holds the answering
    replica's span (``worker.infer`` in that worker's pid, or the
    in-process replica's ``batcher.execute``, parented into the request
    or listing its rid when the request was coalesced into another's
    batch); a request that failed over off the SIGKILLed worker ends
    under its original trace id."""
    from incubator_mxnet_tpu_torch.obs import trace
    mxtrace = mxtrace_tool()
    t0 = time.perf_counter()
    trace.flush()
    spans, events, chrome = mxtrace.load_inputs([span_path])
    merged, summary = mxtrace.merge(spans, events, chrome)
    merge_s = time.perf_counter() - t0
    check(summary["orphan_spans"] == 0,
          f"21a: {summary['orphan_spans']} orphan spans: "
          f"{summary['orphans'][:3]}")
    kids, roots, batch_of = {}, {}, {}
    for sp in spans:
        if sp.get("pa"):
            kids.setdefault(sp["pa"], []).append(sp)
        if sp["name"] == "router.request":
            roots.setdefault(sp["args"].get("rid"), []).append(sp)
        elif sp["name"] == "batcher.execute":
            for rid in str(sp["args"].get("rids", "")).split(","):
                batch_of[rid] = sp
    pids = info["pids"]
    tally = {"l0": 0, "l1": 0, "w0": 0, "w1": 0, "w1_spans": 0,
             "coalesced": 0}
    failed_over = []
    for rid in info["answered"]:
        found = roots.get(rid, [])
        check(len(found) == 1, f"21a: request {rid}: {len(found)} "
              "router.request roots")
        root = found[0]
        reached, frontier = [], [root]
        while frontier:
            cur = frontier.pop()
            reached.append(cur)
            frontier += kids.get(cur["sp"], [])
        check(all(sp["tr"] == root["tr"] for sp in reached),
              f"21a: request {rid}: a span of its tree left its trace")
        who = info["by"].get(rid, "w1")
        check(root["args"].get("outcome") == "ok" and
              root["args"].get("replica") == who,
              f"21a: request {rid}: root args {root['args']}, executed by "
              f"{who}")
        tally[who] += 1
        if root["args"].get("dispatches", 1) > 1:
            failed_over.append(rid)
        if who in ("w0", "w1"):
            held = any(sp["name"] == "worker.infer" and
                       sp["pid"] == pids[who] for sp in reached)
            if who == "w0":
                check(held, f"21a: request {rid}: no worker.infer in w0's "
                      f"pid {pids['w0']} in its tree")
            tally["w1_spans"] += who == "w1" and held
            continue
        batch = next((sp for sp in reached
                      if sp["name"] == "batcher.execute"), None)
        if batch is None:
            batch = batch_of.get(rid)
            tally["coalesced"] += batch is not None
        check(batch is not None and batch["pid"] == pids["main"],
              f"21a: request {rid}: no batcher.execute of {who}")
    check(len(failed_over) >= 1 and info["failovers"] >= 1,
          f"21a: no request failed over ({info['failovers']} failovers)")
    for rid in failed_over:
        check(info["by"].get(rid, "w1") != "w1",
              f"21a: request {rid} failed over yet answered by w1")
    print(f"21a: {summary['spans']} spans in {summary['traces']} traces "
          f"from {summary['processes']} processes merged by "
          f"tools/mxtrace.py in {merge_s:.2f} s, 0 orphans; each of 20a's "
          f"{len(info['answered'])} answered requests one router.request "
          f"tree holding its replica's span (l0 {tally['l0']}, l1 "
          f"{tally['l1']} in batcher.execute, {tally['coalesced']} of them "
          f"coalesced into another request's batch; w0 {tally['w0']} in its "
          f"worker.infer at pid {pids['w0']}); w1 answered {tally['w1']} "
          f"before its SIGKILL, {tally['w1_spans']} of whose worker.infer "
          f"spans it had flushed (a killed process loses its unflushed "
          f"buffer); {len(failed_over)} failed over, each ended ok under "
          f"its original trace id [{card}]")
    return {"spans": summary["spans"], "traces": summary["traces"],
            "processes": summary["processes"], "merge_s": merge_s,
            "failed_over": len(failed_over), "w1_flushed":
            (tally["w1_spans"], tally["w1"])}


def load21(mx, srv, loads):
    """One closed-loop lane of 21d over ModelServer `srv`: -> requests/s,
    p50 and p99 ms of the clients' own latencies."""
    lat, errors = [], []
    lock = threading.Lock()
    gate = threading.Barrier(len(loads) + 1)

    def client(xs):
        gate.wait()
        for x in xs:
            t = time.perf_counter()
            try:
                srv.predict("vgg", {"data": x}, timeout_ms=600_000)
            except Exception as exc:   # fails the run below
                errors.append(repr(exc))
                return
            with lock:
                lat.append((time.perf_counter() - t) * 1e3)

    threads = [threading.Thread(target=client, args=(xs,), daemon=True)
               for xs in loads]
    for t in threads:
        t.start()
    gate.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    check(not errors and not any(t.is_alive() for t in threads),
          f"21d: requests failed: {errors[:3]}")
    return {"rps": len(lat) / wall, "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99))}


def telemetry21(mx, card, prefix, workdir):
    """21c and 21d on phase 4's server (VGG-16, TPU_PALLAS, buckets 1-32,
    phase 4's seeded weights from 20a's checkpoint `prefix`): the
    profiler around PROFILE21_BATCHES bucket-32 batches with a Task, a
    Frame, a Counter and a Marker, the dumped chrome trace and the
    tables; then requests/s and p50/p99 with tracing off and on, and the
    span's calibrated cost.  -> the numbers and K1's launches."""
    from incubator_mxnet_tpu_torch import profiler
    from incubator_mxnet_tpu_torch.obs import trace
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    out = {}
    srv = mx.serving.ModelServer(max_queue_latency_ms=5.0, ctx=mx.gpu(0))
    k1_0 = fc_relu.launches
    try:
        srv.load_model("vgg", prefix=prefix,
                       data_shapes=[("data", (1,) + IMAGE)], buckets=BUCKETS)
        rng = np.random.RandomState(SEED + 210)
        x = rng.rand(max(BUCKETS), *IMAGE).astype(np.float32)
        dump = os.path.join(workdir, "profile21.json")
        profiler.set_config(filename=dump)
        for tries in range(1, 4):
            profiler.dumps(reset=True)
            launches = fc_relu.launches
            profiler.set_state("run")
            counter = profiler.Counter("21c.batches", value=0)
            with profiler.Task("21c.serve"):
                for _ in range(PROFILE21_BATCHES):
                    with profiler.Frame("21c.batch"):
                        srv.predict("vgg", {"data": x}, timeout_ms=600_000)
                    counter += 1
                profiler.Marker("21c.done").mark()
            torch.cuda.synchronize()
            mem = profiler.record_memory("21c", ctx=mx.gpu(0))
            profiler.set_state("stop")
            launches = fc_relu.launches - launches
            profiler.dump()
            with open(dump) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            if kernels:
                break
        check(kernels, "21c: the profiler recorded no CUDA kernel in "
              f"{tries} sessions")
        names = {e.get("name") for e in events}
        want = ("21c.serve", "21c.batch", "21c.batches", "21c.done",
                "Memory:21c", "serving:vgg")
        check(all(w in names for w in want), f"21c: custom events missing "
              f"from the chrome trace: {[w for w in want if w not in names]}")
        table = profiler.dumps()
        check("21c.serve: count=1" in table and "21c.batch: count="
              f"{PROFILE21_BATCHES}" in table and
              "torch.profiler (last session):" in table,
              "21c: dumps() lacks the per-op table")
        check(mem is not None and mem["bytes_in_use"] > 0,
              f"21c: record_memory read {mem}")
        k1_seen = collections.Counter(
            next(k for k in K1_KERNELS if k in e["name"]) for e in kernels
            if any(k in e["name"] for k in K1_KERNELS))
        out["21c"] = {"kernels": len(kernels), "events": len(events),
                      "k1_seen": dict(k1_seen), "k1": launches,
                      "bytes_in_use": mem["bytes_in_use"], "tries": tries}
        print(f"21c: profiler.set_state('run') around {PROFILE21_BATCHES} "
              f"bucket-32 batches (session {tries}): the dumped chrome "
              f"trace loads as JSON, {len(events)} events, {len(kernels)} "
              f"CUDA kernels, the Task, Frame, Counter, Marker, memory and "
              f"serving events; dumps() {len(table.splitlines())} lines "
              f"with the per-op table; record_memory bytes_in_use "
              f"{mem['bytes_in_use']} peak {mem['peak_bytes_in_use']}; K1 "
              f"kernels in the trace {dict(k1_seen)} against "
              f"fc_relu.launches {launches} (printed, not held: a session "
              f"can drop kernels) [{card}]")
        profiler.dumps(reset=True)
        # 21d: the same load with tracing off and on, in turns
        loads = [[rng.rand(rng.randint(1, 9), *IMAGE).astype(np.float32)
                  for _ in range(REQUESTS21)] for _ in range(CLIENTS)]
        load21(mx, srv, loads)                   # warm
        span_file = os.path.join(workdir, "spans21d.jsonl")
        lanes = {"off": [], "on": []}
        spans = 0
        for mode in ("off", "on", "on", "off"):
            if mode == "on":
                trace.enable(span_file)
                ended = trace.stats()["ended"]
            lanes[mode].append(load21(mx, srv, loads))
            if mode == "on":
                spans += trace.stats()["ended"] - ended
                trace.flush()
                trace.disable()
        trace.enable(span_file)
        cost_s = trace.calibrate_span_cost()
        trace.disable()
        n = 2 * CLIENTS * REQUESTS21
        agg = {m: {k: statistics.mean(r[k] for r in runs)
                   for k in ("rps", "p50_ms", "p99_ms")}
               for m, runs in lanes.items()}
        out["21d"] = dict(agg, span_ns=cost_s * 1e9,
                          spans_per_request=spans / n)
        print(f"21d: {CLIENTS} clients x {REQUESTS21} requests a lane, "
              f"lanes off/on/on/off: tracing off " + ", ".join(
                  f"{r['rps']:.1f} requests/s p50 {r['p50_ms']:.1f} p99 "
                  f"{r['p99_ms']:.1f} ms" for r in lanes["off"])
              + "; on " + ", ".join(
                  f"{r['rps']:.1f} requests/s p50 {r['p50_ms']:.1f} p99 "
                  f"{r['p99_ms']:.1f} ms" for r in lanes["on"])
              + f"; on/off requests/s {agg['on']['rps'] / agg['off']['rps']:.3f}"
              f"; {spans / n:.3f} spans a request; calibrate_span_cost "
              f"{cost_s * 1e9:.0f} ns a span (printed, not held) [{card}]")
    finally:
        trace.disable()
        if profiler.state() == "run":
            profiler.set_state("stop")
        profiler.set_config(filename="profile.json")
        srv.shutdown(drain=True)
    out["k1"] = fc_relu.launches - k1_0
    return out


def fleet_phase(card, workdir):
    """Phase 20: the serving fleet (slice 18), 20a-20e, traced: every
    process appends its spans to one file (MXNET_OBS_TRACE, which the
    worker, host daemon and shard server processes inherit); 21b scrapes
    the fleet inside 20c; then phase 21's 21a (the merged spans), 21c and
    21d (`telemetry21`).  Returns K1's launches on its paths and the
    numbers of the summary lines.  K2 and K3 must not run."""
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.obs import trace
    from incubator_mxnet_tpu_torch.ops.flash_attention import (
        flash_fwd, flash_fwd_stream)
    vgg_k1_held("phase 20")
    for wrapper in (flash_fwd, flash_fwd_stream):
        wrapper.launches = 0
    tmp = tempfile.mkdtemp(dir=workdir)
    span_path = os.path.join(tmp, "spans.jsonl")
    knobs = dict(KNOBS20, MXNET_OBS_TRACE=span_path)
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    trace.enable(span_path)
    out, times = {}, {}
    # the host daemons (20c) and shard servers (20e) start now, idle
    # until their sub-phase
    launcher, hosts, host_errors = hosts20(mx)
    shards = [shard20() for _ in range(WD_CFG["shards"])]
    try:
        t0 = time.perf_counter()
        out["router"] = router20(mx, card, tmp)
        times["20ab"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        launcher.join()
        check(not host_errors, f"20c: a host daemon did not start: "
              f"{host_errors}")
        out["20c"] = fleet20(mx, card, hosts, os.path.join(tmp, "vgg20"),
                             out["router"]["solo_ms"])
        times["20c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["20d"] = decode20(mx, card)
        times["20d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["20e"] = embed20(mx, card, tmp, shards)
        times["20e"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["21a"] = spans21(span_path, out["router"]["spans21"], card)
        trace.disable()
        out["21cd"] = telemetry21(mx, card, os.path.join(tmp, "vgg20"), tmp)
        times["21acd"] = time.perf_counter() - t0
    finally:
        trace.disable()
        launcher.join()
        kill_hosts20(hosts)
        for proc, _ in shards:
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)
    for key, secs in times.items():
        print(f"phase {key}: {secs:.1f} s")
    check([flash_fwd.launches, flash_fwd_stream.launches] == [0, 0],
          "phase 20: K2/K3 ran")
    out["times"] = times
    out["k1"] = {"router_local": out["router"]["k1_local"],
                 "router_workers": out["router"]["k1_workers"],
                 "fleet_workers": out["20c"]["k1"],
                 "embedding_serving": out["20e"]["k1"],
                 "telemetry_server": out["21cd"]["k1"]}
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dtype_keys(prefix, rep):
    """A kernel's case in a second dtype under keys of their own in the
    JSON line."""
    return {f"{prefix}_{key}": rep[key] for key in
            ("shape", "ms", "bound_ms", "bound_by", "library_ms",
             "max_abs_err")}


# -- phase 22: the training guardian and the train-to-serve loop (slice 20)
# 22a: train_mnist's mlp (K1 at fc1 and fc2) through Module.fit with
# checkpoints, 8 batches of 64 an epoch, 2 epochs; the guardian polls
# every 4 steps and warms its spike detector over 4 (the JAX package's
# own tests' settings), so a spike at step 10 is diagnosed
GUARD22 = dict(images=512, batch=64, epochs=2, period=4, lr=0.1,
               momentum=0.9)
GUARD22_ENV = {"MXNET_GUARDIAN_INTERVAL": "4",
               "MXNET_GUARDIAN_SPIKE_WINDOW": "4"}
GUARD22_SKIP = "seed=7;grad.nonfinite:error(at=5)"
GUARD22_SPIKE = "seed=7;loss.spike:error(at=10)"
GUARD22_DIVERGE = "seed=7;grad.nonfinite:error(at=3-12)"
GUARD22_NAN_BATCH = 4          # the NaN batch of the guardian on/off run
GUARD22_KEYS = ("reason", "step", "epoch", "nbatch", "shard")
GUARD22_SYNC_STEPS = 8         # 22b: guarded steps under sync debug mode
# 22c: AlexNet (Dropout 0, fp32, K1 at fc6/fc7) fine-tunes fc6, fc7 and
# its classifier on a seeded 10-class task (a random pattern per class
# plus noise) from a boot model whose classifier holds the classes'
# centred mean fc7 features, scaled so that the boot model's mean
# log-likelihood of the true class is `boot_loglik` (below the task's
# ceiling of 0); the canary scores that log-likelihood on a holdout of
# `holdout` images (`loglik22`) with the JAX default tolerance, and the
# last promoted version must beat the boot model's score by `gain`; a
# checkpoint every 4 steps, the publisher's cadence 2 steps (a torn
# publish is retried before the next checkpoint exists); after training,
# a degraded version (the live classifier scaled by `degrade`: the same
# argmax, softer answers) and a poisoned one (negated) are published
LOOP22 = dict(classes=10, noise=0.3, batch=128, batches=8, epochs=3,
              period=4, publish=2, boot_batches=2, boot_loglik=-1.0,
              holdout=128, lr=0.001, momentum=0.9, tol=0.02, gain=0.05,
              degrade=0.25, poll_s=0.2, clients=2, rows=(1, 2, 4, 8),
              torn="seed=3;publish.commit:torn(at=2)", wait_s=60.0)
DEV22 = "cuda"                # 22c's torch device (a CPU rehearsal: "cpu")


def guard22_params(mx, seed=SEED):
    """The mlp's parameters from a numpy seed (the same on the card and
    on the CPU)."""
    rng = np.random.RandomState(seed)
    shapes = {"fc1": (128, 784), "fc2": (64, 128), "fc3": (10, 64)}
    out = {}
    for name, (n, k) in shapes.items():
        out[f"{name}_weight"] = (rng.normal(0, 1, (n, k)) /
                                 np.sqrt(k)).astype("f4")
        out[f"{name}_bias"] = np.zeros(n, "f4")
    return out


def nan22(mx, inner, bad):
    """`inner`'s batches with batch `bad` of each epoch all NaN."""

    class Nan22(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=inner.batch_size)
            self._i = 0

        provide_data = property(lambda self: inner.provide_data)
        provide_label = property(lambda self: inner.provide_label)

        def reset(self):
            inner.reset()
            self._i = 0

        def next(self):
            batch = inner.next()
            self._i += 1
            if self._i - 1 != bad:
                return batch
            nan = mx.nd.array(np.full(batch.data[0].shape, np.nan, "f4"),
                              ctx=mx.cpu())
            return mx.io.DataBatch([nan], batch.label, pad=0)

    return Nan22()


def guard22_fit(mx, ctx, ck=None, spec=None, num_epoch=None, resume=False,
                nan_batch=None):
    """One seeded Module.fit of the mlp under TPU_PALLAS on `ctx`."""
    from incubator_mxnet_tpu_torch.resilience import faults
    g = GUARD22
    x, y = mx.test_utils.get_mnist_like(g["images"])
    it = mx.io.NDArrayIter(x, y, g["batch"], shuffle=False)
    if nan_batch is not None:
        it = nan22(mx, it, nan_batch)
    mod = mx.mod.Module(mlp_symbol(mx), context=ctx)
    args = {k: mx.nd.array(v, ctx=mx.cpu())
            for k, v in guard22_params(mx).items()}
    if spec:
        faults.configure(spec)
    try:
        mod.fit(it, num_epoch=num_epoch or g["epochs"], optimizer="sgd",
                optimizer_params={"learning_rate": g["lr"],
                                  "momentum": g["momentum"]},
                eval_metric="acc", arg_params=args, kvstore=None,
                checkpoint_dir=ck, checkpoint_period=g["period"],
                resume=resume)
    finally:
        faults.clear()
    return mod


def guard22_sha(mod):
    import hashlib
    args, auxs = mod.get_params()
    h = hashlib.sha256()
    for k in sorted(args):
        h.update(args[k].asnumpy().tobytes())
    for k in sorted(auxs):
        h.update(auxs[k].asnumpy().tobytes())
    return h.hexdigest()


def guard22_decisions(mod, ck):
    """What a guarded run decided: its quarantine lines (the decision
    keys), rollback step window and counters."""
    from incubator_mxnet_tpu_torch.resilience.guardian import QuarantineLog
    g = mod._guardian
    q = QuarantineLog(os.path.join(ck, "quarantine.jsonl")).load() \
        if ck else []
    st = g.stats()
    return {"quarantine": [tuple(e.get(k) for k in GUARD22_KEYS)
                           for e in q],
            "signals": [e.get("signal") for e in q],
            "window": g.last_rollback_window,
            "stats": {k: st[k] for k in ("steps_observed", "polls", "skips",
                                         "spikes", "rollbacks",
                                         "quarantined")}}


def guard22_scenarios(mx, ctx, root):
    """22a's runs on `ctx`: skip (twice), spike + its clean reference,
    divergence, resume over the quarantine."""
    from incubator_mxnet_tpu_torch.resilience import TrainingDivergedError
    out = {}
    skip = [guard22_fit(mx, ctx, os.path.join(root, f"skip{i}"),
                        GUARD22_SKIP) for i in range(2)]
    out["skip_sha"] = [guard22_sha(m) for m in skip]
    out["skip"] = guard22_decisions(skip[1], os.path.join(root, "skip1"))
    out["skip_finite"] = all(np.isfinite(a.asnumpy()).all()
                             for a in skip[1].get_params()[0].values())
    spike = guard22_fit(mx, ctx, os.path.join(root, "spike"), GUARD22_SPIKE)
    out["spike"] = guard22_decisions(spike, os.path.join(root, "spike"))
    os.makedirs(os.path.join(root, "ref"))
    shutil.copy(os.path.join(root, "spike", "quarantine.jsonl"),
                os.path.join(root, "ref", "quarantine.jsonl"))
    ref = guard22_fit(mx, ctx, os.path.join(root, "ref"))
    out["spike_sha"], out["ref_sha"] = guard22_sha(spike), guard22_sha(ref)
    out["ref_rollbacks"] = ref._guardian.stats()["rollbacks"]
    os.environ["MXNET_GUARDIAN_MAX_FAILURES"] = "2"
    try:
        guard22_fit(mx, ctx, None, GUARD22_DIVERGE)
        out["diverged"] = None
    except TrainingDivergedError as e:
        out["diverged"] = (e.step, e.shard, e.signal)
    finally:
        os.environ.pop("MXNET_GUARDIAN_MAX_FAILURES")
    rck = os.path.join(root, "resume")
    guard22_fit(mx, ctx, rck, GUARD22_SKIP, num_epoch=1)
    resumed = guard22_fit(mx, ctx, rck, resume=True)
    pos = [(q[2], q[3]) for q in guard22_decisions(
        resumed, rck)["quarantine"]]
    g = resumed._guardian
    out["resume"] = {"positions": pos,
                     "skipped": all(g.should_skip(*p) for p in pos),
                     "new_skips": g.stats()["skips"]}
    return out


def guard22_mlp(mx, card, workdir):
    """22a: the guardian on BASELINE config #1's mlp (K1 at fc1 and fc2)
    through Module.fit with checkpoints, on the card and on the CPU."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    root = tempfile.mkdtemp(dir=workdir, prefix="guard22-")
    try:
        fc_relu.launches = 0
        gpu = guard22_scenarios(mx, mx.gpu(0), os.path.join(root, "gpu"))
        on = guard22_fit(mx, mx.gpu(0), nan_batch=GUARD22_NAN_BATCH,
                         num_epoch=1)
        launches = fc_relu.launches
        os.environ["MXNET_GUARDIAN"] = "0"
        try:
            off = guard22_fit(mx, mx.gpu(0), nan_batch=GUARD22_NAN_BATCH,
                              num_epoch=1)
        finally:
            os.environ.pop("MXNET_GUARDIAN")
        cpu = guard22_scenarios(mx, mx.cpu(), os.path.join(root, "cpu"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    finite = {name: all(np.isfinite(a.asnumpy()).all()
                        for a in m.get_params()[0].values())
              for name, m in (("on", on), ("off", off))}
    sk, sp = gpu["skip"], gpu["spike"]
    print(f"22a skip: {GUARD22_SKIP!r}: {sk['stats']['skips']} skip(s), "
          f"quarantine {sk['quarantine']}; two seeded runs "
          f"{'sha256-equal' if len(set(gpu['skip_sha'])) == 1 else 'DIFFER'}"
          f" ({gpu['skip_sha'][0][:16]}); parameters finite "
          f"{gpu['skip_finite']} [{card}]")
    print(f"22a NaN batch {GUARD22_NAN_BATCH}: guardian on, parameters "
          f"finite {finite['on']} ({on._guardian.stats()['skips']} skip); "
          f"MXNET_GUARDIAN=0, parameters finite {finite['off']} "
          f"(poisoned) [{card}]")
    print(f"22a rollback: {GUARD22_SPIKE!r}: {sp['stats']['rollbacks']} "
          f"rollback, window {sp['window']}, quarantine {sp['quarantine']}"
          f", spike signal {sp['signals'][0]:.6g}; against a clean run over"
          f" the same quarantine "
          f"{'sha256-equal' if gpu['spike_sha'] == gpu['ref_sha'] else 'DIFFER'}"
          f" [{card}]")
    print(f"22a divergence: {GUARD22_DIVERGE!r} with MAX_FAILURES=2: "
          f"TrainingDivergedError at step {gpu['diverged'][0]}, signal "
          f"{gpu['diverged'][2]}, shard {gpu['diverged'][1]} [{card}]")
    print(f"22a resume: quarantined positions {gpu['resume']['positions']}"
          f" skipped on resume {gpu['resume']['skipped']}, "
          f"{gpu['resume']['new_skips']} new skips [{card}]")
    same = {k: (gpu[k]["quarantine"], gpu[k]["window"], gpu[k]["stats"])
            == (cpu[k]["quarantine"], cpu[k]["window"], cpu[k]["stats"])
            for k in ("skip", "spike")}
    sig = max(abs(a / b - 1) for a, b in zip(sp["signals"],
                                             cpu["spike"]["signals"])
              if a is not None and b is not None)
    div_same = gpu["diverged"][:2] == cpu["diverged"][:2]
    print(f"22a card vs CPU: skip decisions equal {same['skip']}, rollback "
          f"decisions equal {same['spike']} (quarantined signals within "
          f"{sig:.2e} relative), divergence step and shard equal "
          f"{div_same}, resume positions equal "
          f"{gpu['resume']['positions'] == cpu['resume']['positions']}")
    print(f"22a guardian_fit: K1 {launches} launches over the card's fits "
          f"[{card}]")
    ok = (len(set(gpu["skip_sha"])) == 1 and sk["stats"]["skips"] == 1
          and gpu["skip_finite"] and finite["on"] and not finite["off"]
          and sp["stats"]["rollbacks"] == 1
          and gpu["spike_sha"] == gpu["ref_sha"]
          and gpu["ref_rollbacks"] == 0 and gpu["diverged"] is not None
          and gpu["diverged"][1] and gpu["resume"]["skipped"]
          and gpu["resume"]["positions"]
          and gpu["resume"]["new_skips"] == 0 and all(same.values())
          and div_same and sig <= 1e-3
          and gpu["resume"]["positions"] == cpu["resume"]["positions"]
          and launches > 0)
    check(ok, "22a: a guardian gate failed (see the 22a lines)")
    return {"launches": launches, "skip": sk, "spike": sp,
            "diverged": gpu["diverged"]}


def sync_calls(fn, n):
    """(count, where) of the synchronizing CUDA calls in `n` calls of
    `fn`, as torch.cuda.set_sync_debug_mode('warn') reports them; `where`
    lists each call's "file:line" in the Python code that made it."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    hits = [w for w in caught if "synchroniz" in str(w.message)]
    return len(hits), [f"{os.path.basename(w.filename)}:{w.lineno}"
                       for w in hits]


def burst_ms(fn, reps=10):
    """Mean time of fn() over `reps` calls enqueued back to back between
    two CUDA events, after one warm call: while a call moves hundreds of
    MB the host enqueues the next, so its launch gaps stay hidden."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def guard22_lanes(mx, card):
    """22b's lanes in one process: 17b's AlexNet lane (bf16, batch 128,
    K1 at fc6/fc7) through Module.fit unguarded, guarded, guarded,
    unguarded (an order that favours neither side), then phase 6's mlp
    fit unguarded and guarded; returns (guarded AlexNet module, its K1
    launches, its guardian's stats, AlexNet's lanes, the mlp's)."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    batch, warm, timed = (ALEX_LANE[k] for k in ("batch", "warm", "timed"))
    _, sym = alex_symbol(mx, DROP_RATE)
    lanes, mlp, kept = {}, {}, None
    for name in ("off", "on", "on2", "off2"):
        guarded = name.startswith("on")
        if not guarded:
            os.environ["MXNET_GUARDIAN"] = "0"
        fc_relu.launches = 0
        base = torch.cuda.memory_allocated() / 2 ** 30
        try:
            mod, lanes[name] = resnet_lane(
                mx, sym, "bfloat16", batch, warm, timed, card,
                PEAK_FLOPS[BF16], opt=OPT17,
                label=f"22b alexnet {'guarded' if guarded else 'unguarded'}")
        finally:
            os.environ.pop("MXNET_GUARDIAN", None)
        # the lane's peak above what was allocated when it started
        lanes[name]["peak_gib"] -= base
        if name == "on":
            kept = (mod, fc_relu.launches, mod._guardian.stats())
        del mod
        gc.collect()
    for name in ("off", "on"):
        if name == "off":
            os.environ["MXNET_GUARDIAN"] = "0"
        print(f"22b mlp: phase 6's fit, guardian {name}:")
        try:
            mod, _, mlp[name] = fit_case(mx, "mlp", mlp_symbol(mx), card)
        finally:
            os.environ.pop("MXNET_GUARDIAN", None)
        del mod
    return kept + (lanes, mlp)


def guard22_parts(fs, card):
    """Where the guarded step's added device time goes: each part of the
    health word and the select on AlexNet's tensors, timed with CUDA
    events (`burst_ms`), beside the bytes it must move and the rate
    that makes; stand-in gradients of the weights' shapes and dtypes;
    the flag true, so the tensors keep their bits."""
    from incubator_mxnet_tpu_torch import fused as _fused
    plan = fs._guard_plan()
    _, live, old, n, groups = plan
    ws, old_ws = live[:n], old[:n]
    g = torch.Generator(device="cuda").manual_seed(SEED)
    grads = [torch.randn(w.shape, generator=g, device="cuda", dtype=w.dtype)
             for w in ws]
    ok = torch.ones((), dtype=torch.bool, device="cuda")
    dev = torch.device("cuda")
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa
    state, wb = size(live), size(ws)
    parts = {
        "copy": (lambda: [torch._foreach_copy_(o, t) for t, o in groups],
                 2 * state),
        "flag norms (gradients, new weights)":
            (lambda: _fused._norms(grads + ws, dev), 2 * wb),
        "old weights' norm": (lambda: _fused._norms(old_ws, dev), wb),
        "select": (lambda: _fused._select(ok, live, old), 3 * state),
        "displacement (sub into old, norm)":
            (lambda: (torch._foreach_sub_(old_ws, ws),
                      _fused._norms(old_ws, dev)), 4 * wb)}
    out = {k: (burst_ms(fn), nbytes) for k, (fn, nbytes) in parts.items()}

    def whole():
        for t, o in groups:
            torch._foreach_copy_(o, t)
        fs._health(grads, [], plan)

    out["all of it (copy + _health)"] = (
        burst_ms(whole), sum(nb for _, nb in out.values()))
    print(f"22b where the guarded step's time goes (CUDA events, 10 calls "
          f"back to back; {len(live)} tensors, {state / 1e6:.1f} MB of "
          f"weights, fp32 masters and momenta, {wb / 1e6:.1f} MB of "
          f"weights) [{card}]:")
    for k, (ms, nb) in out.items():
        print(f"22b   {k}: {ms:.3f} ms, {nb / 1e6:.1f} MB moved at least, "
              f"{nb / ms / 1e9:.2f} TB/s (the card's {HBM_BYTES_S / 1e12:.2f}"
              f"), bound {nb / HBM_BYTES_S * 1e3:.3f} ms")
    return {k: ms for k, (ms, _) in out.items()}


def guard22_alexnet(mx, card):
    """22b: the guardian's cost on 17b's AlexNet lane and phase 6's mlp
    (`guard22_lanes`), one warm AlexNet step profiled unguarded and
    guarded, the parts of the added time (`guard22_parts`), and the
    guarded and unguarded fused step's synchronizing calls between
    polls."""
    from incubator_mxnet_tpu_torch.resilience import TrainingGuardian
    batch, warm, timed = (ALEX_LANE[k] for k in ("batch", "warm", "timed"))
    mod, launches, st, lanes, mlp = guard22_lanes(mx, card)
    one = next(resident_iter(mx, batch, "bfloat16", 1))
    metric = mx.metric.create("acc")
    fs = mod._fused_step
    step = lambda: mod.fit_step(one, metric)    # noqa: E731
    guard = TrainingGuardian(interval=10 ** 9)
    prof = {}
    for name, g in (("unguarded", None), ("guarded", guard)):
        fs.attach_guardian(g)
        prof[name] = profile_one_step(step, card,
                                      f"22b alexnet profile {name}", batch)
    counts = {}
    # unguarded, guarded, unguarded again: a call that syncs once in
    # whichever window comes first shows in both unguarded windows' sum
    for name, g in (("plain", None), ("guarded", guard), ("plain2", None)):
        fs.attach_guardian(g)
        step()
        counts[name] = sync_calls(step, GUARD22_SYNC_STEPS)
    plain = min(counts["plain"][0], counts["plain2"][0])
    guarded = counts["guarded"][0]
    polled = guard.stats()["polls"]
    parts = guard22_parts(fs, card)
    mean = lambda a, b: (a + b) / 2   # noqa: E731
    off = {k: mean(lanes["off"][k], lanes["off2"][k])
           for k in ("step_ms", "images_s")}
    on = {k: mean(lanes["on"][k], lanes["on2"][k])
          for k in ("step_ms", "images_s")}
    cost = on["step_ms"] / off["step_ms"] - 1
    peak = [max(lanes[a]["peak_gib"], lanes[b]["peak_gib"])
            for a, b in (("off", "off2"), ("on", "on2"))]
    print(f"22b alexnet guardian cost: step median "
          f"{lanes['off']['step_ms']:.3f} / {lanes['off2']['step_ms']:.3f} ms"
          f" off, {lanes['on']['step_ms']:.3f} / {lanes['on2']['step_ms']:.3f}"
          f" ms on ({cost:+.4f} on the means); images/s {off['images_s']:.1f}"
          f" off, {on['images_s']:.1f} on; peak above the lane's start "
          f"{peak[0]:.2f} off / {peak[1]:.2f} on GiB; "
          f"{st['steps_observed']} steps observed, "
          f"{st['polls']} polls, {st['skips']} skips [{card}]")
    pu, pg = prof["unguarded"], prof["guarded"]
    print(f"22b alexnet one warm step profiled: unguarded {pu['kernels']} "
          f"kernels, device {pu['device_ms']:.3f} ms, host "
          f"{pu['host_ms']:.3f} ms to enqueue; guarded {pg['kernels']} "
          f"kernels, device {pg['device_ms']:.3f} ms, host "
          f"{pg['host_ms']:.3f} ms; the guard adds "
          f"{pg['kernels'] - pu['kernels']} kernels, "
          f"{pg['device_ms'] - pu['device_ms']:.3f} ms of device time "
          f"and {pg['host_ms'] - pu['host_ms']:.3f} ms of host time "
          f"[{card}]")
    mcost = mlp["on"]["step_ms"] / mlp["off"]["step_ms"] - 1
    print(f"22b mlp guardian cost (phase 6's fit, host-bound): step median "
          f"{mlp['off']['step_ms']:.3f} ms off, {mlp['on']['step_ms']:.3f} ms"
          f" on ({mcost:+.4f}); samples/s {mlp['off']['samples_s']:.0f} off, "
          f"{mlp['on']['samples_s']:.0f} on [{card}]")
    print(f"22b synchronizing calls over {GUARD22_SYNC_STEPS} steps "
          f"(torch.cuda.set_sync_debug_mode('warn')): unguarded "
          f"{counts['plain'][0]} then {counts['plain2'][0]}, guarded "
          f"between polls {guarded} ({polled} polls); where: " +
          "; ".join(f"{k} {v[1]}" for k, v in counts.items() if v[1])
          + f" {'ok' if guarded <= plain else 'FAIL'} [{card}]")
    print(f"22b alexnet_guarded: K1 {launches} launches over "
          f"{warm + timed} guarded train forwards [{card}]")
    check(guarded <= plain and polled == 0,
          f"22b: the guarded step synchronizes {guarded} times against "
          f"the unguarded step's {plain}")
    check(launches == 2 * (warm + timed) and
          st["steps_observed"] == warm + timed and st["skips"] == 0,
          f"22b: K1 {launches} launches, {st['steps_observed']} steps "
          "observed")
    return {"off": off, "on": on, "cost": cost, "mlp_cost": mcost,
            "syncs": (plain, guarded), "parts": parts, "launches": launches}


def task22(mx, seed, batches, batch):
    """LOOP22's seeded task on the card, as a DataIter: class k's images
    are pattern k plus `noise` Gaussian noise; `batches` batches of
    `batch` an epoch, the same every epoch (batch i drawn from seed + i);
    `draw(i, n)` gives any draw."""
    c = LOOP22["classes"]
    rng = np.random.RandomState(SEED + 2200)
    patterns = torch.from_numpy(rng.rand(c, *IMAGE).astype("f4")).to(DEV22)

    class Task22(mx.io.DataIter):
        def __init__(self):
            super().__init__(batch_size=batch)
            self._i = 0

        @property
        def provide_data(self):
            return [mx.io.DataDesc("data", (batch,) + IMAGE)]

        @property
        def provide_label(self):
            return [mx.io.DataDesc("softmax_label", (batch,))]

        def draw(self, i, n=None):
            n = n or batch
            r = np.random.RandomState(seed + i)
            # every class equally often (up to n % c): a balanced batch
            # keeps the classifier's biases from drifting to one class
            y = torch.from_numpy(r.permutation(np.arange(n) % c)).to(DEV22)
            g = torch.Generator(device=DEV22).manual_seed(seed + i)
            x = patterns[y] + LOOP22["noise"] * torch.randn(
                (n,) + IMAGE, generator=g, device=DEV22)
            return x, y.to(torch.float32)

        def reset(self):
            self._i = 0

        def next(self):
            if self._i >= batches:
                raise StopIteration
            x, y = self.draw(self._i)
            self._i += 1
            return mx.io.DataBatch([mx.nd.NDArray(x, ctx=mx.gpu(0))],
                                   [mx.nd.NDArray(y, ctx=mx.gpu(0))], pad=0)

    return Task22()


def loglik22(outputs, labels):
    """22c's canary score: the mean log-softmax that the served logits
    give the true class (higher is better, 0 at best)."""
    out = outputs[0] if isinstance(outputs, (list, tuple)) else outputs
    z = np.asarray(out.asnumpy() if hasattr(out, "asnumpy") else out,
                   dtype=np.float64)
    z = z - z.max(axis=1, keepdims=True)
    lp = z - np.log(np.exp(z).sum(axis=1, keepdims=True))
    y = np.asarray(labels).reshape(-1).astype(np.int64)
    return float(lp[np.arange(len(y)), y].mean())


def loop22_boot(mx, task):
    """The boot model: AlexNet (Dropout 0) from Xavier, its classifier's
    rows 0..9 the classes' centred mean fc7 features (unit norm) over
    `boot_batches` labelled batches times the scale that makes the mean
    log-likelihood of the true class over those batches `boot_loglik`
    (bisection), every other class's bias -1e3."""
    c = LOOP22["classes"]
    net = alex_net(mx, 0.0)
    mx.random.seed(SEED)
    net.initialize(mx.init.Xavier(), ctx=mx.gpu(0))
    feats, labels = [], []
    for i in range(LOOP22["boot_batches"]):
        x, y = task.draw(10 ** 6 + i)
        if i == 0:
            net(mx.nd.NDArray(x, ctx=mx.gpu(0)))    # the deferred shapes
        feats.append(net.features(mx.nd.NDArray(x, ctx=mx.gpu(0))).data)
        labels.append(y)
    f = torch.cat(feats).double()
    y = torch.cat(labels).long()
    mu = f.mean(0)
    m = torch.stack([f[y == k].mean(0) for k in range(c)]) - mu
    w = m / m.norm(dim=1, keepdim=True)
    logits = f @ w.T - w @ mu

    def loglik(scale):
        lp = torch.log_softmax(scale * logits, dim=1)
        return lp[torch.arange(len(y), device=y.device), y].mean().item()

    lo, hi = -12.0, 12.0            # log2 of the scale
    for _ in range(60):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if loglik(2 ** mid) < LOOP22["boot_loglik"] \
            else (lo, mid)
    w = w * 2 ** lo
    values = {n: p.data().asnumpy() for n, p in
              net.collect_params().items()}
    wname, bname = f"{ALEX_PREFIX}dense2_weight", f"{ALEX_PREFIX}dense2_bias"
    values[wname] = np.zeros_like(values[wname])
    values[wname][:c] = w.cpu().numpy()
    values[bname] = np.full_like(values[bname], -1e3)
    values[bname][:c] = -(w @ mu).cpu().numpy()
    return values


def loop22_ckpt(mx, root, values, step):
    """One elastic checkpoint of `values`, stamped healthy."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    mgr = ckpt.CheckpointManager(root, keep_last=64)
    mgr.snapshot(arrays={f"arg:{k}": v for k, v in values.items()},
                 step=step, meta={"health": {"status": "healthy"}},
                 sync=True)
    mgr.close()
    return os.path.join(root, "ckpt-%010d" % step)


def loop22(mx, card, workdir):
    """22c: a trainer thread fine-tunes AlexNet through Module.fit with
    checkpoints and a CheckpointPublisher into a ModelRegistry; a
    LoopController canaries (`loglik22`) and promotes each version over
    a ReplicaRouter of two LocalReplicas serving AlexNet (K1 at fc6/fc7,
    buckets 1-32 and the holdout's) while clients send requests; a torn
    publish, a degraded version (classifier scaled down) and a poisoned
    one (classifier negated) are injected."""
    from incubator_mxnet_tpu_torch import checkpoint as ckpt
    from incubator_mxnet_tpu_torch.loop import (CheckpointPublisher,
                                                LoopController,
                                                ModelRegistry)
    from incubator_mxnet_tpu_torch.resilience import faults
    from incubator_mxnet_tpu_torch.serving import LocalReplica, ReplicaRouter
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    L = LOOP22
    buckets = tuple(sorted(set(BUCKETS + (L["holdout"],))))
    for m in sorted(set(buckets + (L["batch"],))):
        alex_k1_held(m, F32, "22c")
    root = tempfile.mkdtemp(dir=workdir, prefix="loop22-")
    t_phase = time.perf_counter()
    # stopped in `finally`, so that a failed gate leaves no thread behind
    stop, ctrl, router, clients = threading.Event(), None, None, []
    try:
        task = task22(mx, SEED + 22, L["batches"], L["batch"])
        boot_values = loop22_boot(mx, task)
        boot = loop22_ckpt(mx, os.path.join(root, "boot"), boot_values, 0)
        _, sym = alex_symbol(mx, 0.0)
        part = mx.subgraph.partition_graph(
            alex_net(mx, 0.0)(mx.sym.Variable("data")), "TPU_PALLAS")
        fused = [n["op"] for n in json.loads(part.tojson())["nodes"]
                 ].count("_sg_pallas_fc_relu")
        check(fused == 2, f"22c: the served graph partitions to {fused} K1 "
              "nodes")
        args = {k: v for k, v in boot_values.items()}
        reps = [LocalReplica(mx.serving.ServedModel(
            part, args, {}, data_shapes=[("data", (1,) + IMAGE)],
            buckets=buckets, ctx=mx.gpu(0), name=f"alex22-{i}"),
            replica_id=f"r{i}") for i in range(2)]
        router = ReplicaRouter(reps, name="loop22", health_interval_s=5.0)
        hx, hy = task.draw(2 * 10 ** 6, L["holdout"])
        holdout = ({"data": hx.cpu().numpy()}, hy.cpu().numpy())
        reg = ModelRegistry(os.path.join(root, "registry"))
        ck_root = os.path.join(root, "ck")
        pub = CheckpointPublisher(reg, ck_root, publish_steps=L["publish"],
                                  publish_secs=0)
        ctrl = LoopController(router, reg, holdout, score_fn=loglik22,
                              canary_tol=L["tol"],
                              poll_interval_s=L["poll_s"],
                              incumbent_checkpoint=boot,
                              eval_timeout_ms=120000)
        promoted, real_promote = [], ctrl._promote

        def promote(cand, inc, can):
            res = real_promote(cand, inc, can)
            promoted.append((cand["version"], time.perf_counter(), inc,
                             can))
            return res

        ctrl._promote = promote
        fixed = [n for n in sym.list_arguments()
                 if n not in ("data", "softmax_label")
                 and not n.startswith(f"{ALEX_PREFIX}dense")]
        mod = mx.mod.Module(sym, context=mx.gpu(0),
                            fixed_param_names=fixed)
        sent, refused, futures = [0], [0], []
        lock = threading.Lock()

        def client(k):
            rng = np.random.RandomState(SEED + 220 + k)
            while not stop.is_set():
                rows = L["rows"][rng.randint(len(L["rows"]))]
                x, _ = task.draw(3 * 10 ** 6 + rng.randint(1000), rows)
                try:
                    fut = router.submit({"data": x.cpu().numpy()},
                                        timeout_ms=120000)
                except Exception:   # noqa: BLE001 - shed at admission
                    with lock:
                        refused[0] += 1
                    continue
                with lock:
                    sent[0] += 1
                    futures.append((rows, fut))
                stop.wait(0.02)

        def pace(p):
            # the trainer waits (at most wait_s) until the controller has
            # decided on every version the registry shows
            seen = reg.latest()
            if seen is None:
                return
            deadline = time.monotonic() + L["wait_s"]
            while ctrl.stats()["live_version"] < seen["version"] and \
                    reg.rejected(seen["version"]) is None and \
                    time.monotonic() < deadline:
                time.sleep(0.02)

        train_err = []

        def train():
            try:
                pub.fit(mod, task, num_epoch=L["epochs"], kvstore=None,
                        optimizer="sgd",
                        optimizer_params={"learning_rate": L["lr"],
                                          "momentum": L["momentum"],
                                          "rescale_grad": 1.0 / L["batch"]},
                        arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in boot_values.items()},
                        eval_metric="acc", checkpoint_dir=ck_root,
                        checkpoint_period=L["period"],
                        checkpoint_keep_last=2, batch_end_callback=[pace])
            except Exception as e:   # noqa: BLE001 - reported below
                train_err.append(e)

        fc_relu.launches = 0
        fc_relu.by_thread.clear()
        faults.configure(L["torn"])
        ctrl.start()
        clients = [threading.Thread(target=client, args=(k,),
                                    name=f"mx-loop22-client-{k}")
                   for k in range(L["clients"])]
        trainer = threading.Thread(target=train, name="mx-loop22-trainer")
        t0 = time.perf_counter()
        for t in clients + [trainer]:
            t.start()
        trainer.join(timeout=600)
        t_train = time.perf_counter()
        check(not trainer.is_alive() and not train_err,
              f"22c: the trainer failed: {train_err}")
        torn = [e["ctx"].get("version") for e in faults.trace()
                if e.get("site") == "publish.commit"]
        faults.clear()
        final = pub.stats()["last_published_version"]
        deadline = time.monotonic() + L["wait_s"]
        while ctrl.stats()["live_version"] < final and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        live = reg.get(ctrl.stats()["live_version"])
        check(live is not None, "22c: no version was promoted")
        # the degraded version, then the poisoned one: the live
        # checkpoint with its classifier scaled by `degrade`, then
        # negated, published as the next steps
        data = ckpt.load(live["checkpoint"])
        other = [r for r in router.replicas()][1]
        other_v = router.stats()["replicas"][other]["version"]
        bad_versions = []
        for k, factor in enumerate((L["degrade"], -1.0)):
            bad = {n.partition(":")[2]: np.asarray(v)
                   for n, v in data.arrays.items()}
            for n in (f"{ALEX_PREFIX}dense2_weight",
                      f"{ALEX_PREFIX}dense2_bias"):
                bad[n] = bad[n] * np.float32(factor)
            vbad = final + 1 + k
            bad_versions.append(vbad)
            reg.publish(loop22_ckpt(mx, os.path.join(root, f"bad{k}"), bad,
                                    vbad),
                        step=vbad, health={"status": "healthy"},
                        watermark={"step": vbad, "time": time.time()})
            deadline = time.monotonic() + L["wait_s"]
            while ctrl.stats()["canary_rejections"] < k + 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
        time.sleep(0.5)      # the clients run through the swap back
        stop.set()
        for t in clients:
            t.join(timeout=60)
        ctrl.stop()
        results = []
        for rows, fut in futures:
            try:
                out = fut.result(timeout=120)
                first = out[0] if isinstance(out, (list, tuple)) else out
                first = first.asnumpy() if hasattr(first, "asnumpy") \
                    else np.asarray(first)
                results.append(first.shape == (rows, CLASSES) and
                               bool(np.isfinite(first).all()))
            except Exception:   # noqa: BLE001 - a lost request
                results.append(False)
        launches = fc_relu.launches
        k1_train = fc_relu.by_thread["mx-loop22-trainer"]
        k1_serve = launches - k1_train
        st = ctrl.stats()
        rstats = router.stats()["replicas"]
        answers = router.predict({"data": holdout[0]["data"]},
                                 timeout_ms=120000)
        served = loglik22(answers, holdout[1])
        router.shutdown()
        scrape = mx.obs.scrape.metrics_reply()
        prom = mx.obs.parse_prometheus(scrape["prom"])
        lag = [v for (name, _), v in prom.items()
               if name.endswith("freshness_lag_s")]
        rejected = [r["version"] for r in
                    reg.versions(include_rejected=True) if r["rejected"]]
        stamps = {v: reg.rejected(v) or {} for v in rejected}
        pst = pub.stats()
        visible = reg.versions()
        steps = L["batches"] * L["epochs"]
    finally:
        faults.clear()
        stop.set()
        for t in clients:
            t.join(timeout=60)
        if ctrl is not None:
            ctrl.stop()
        if router is not None:
            router.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    during = [p for p in promoted if p[1] <= t_train]
    lost = results.count(False)
    nan = float("nan")
    print(f"22c trainer: AlexNet fine-tuned through Module.fit, {steps} "
          f"steps of batch {L['batch']} in {t_train - t0:.2f} s (paced by "
          f"the canary), checkpoints every {L['period']}, published "
          f"{pst['published']} versions (the publish of v{torn[0] if torn else None} torn, "
          f"then published again), fences {pst['fences']} [{card}]")
    print(f"22c canary (mean log-likelihood of the true class over "
          f"{L['holdout']} holdout images, tol {L['tol']}): promotions "
          + ", ".join(f"v{v} ({c:.4f} vs {i:.4f})" for v, _, i, c in promoted)
          + f"; {len(during)} while training ran; rejected "
          + ", ".join(f"v{v} ({stamps[v].get('canary_score', nan):.4f} vs "
                      f"{stamps[v].get('incumbent_score', nan):.4f})"
                      for v in rejected)
          + f" (degraded v{bad_versions[0]}: classifier x {L['degrade']}; "
          f"poisoned v{bad_versions[1]}: negated), canary rejections "
          f"{st['canary_rejections']},"
        f" eval failures {st['eval_failures']}, swap failures "
        f"{st['swap_failures']}; replica versions "
        f"{ {r: s['version'] for r, s in rstats.items()} } (the other "
        f"replica {other} at {other_v} before the poisoned canary) "
        f"[{card}]")
    print(f"22c clients: {sent[0]} requests admitted, {refused[0]} refused "
          f"at admission, {lost} lost or wrong; the fleet's holdout score "
          f"after the rejections {served:.6f}; loop.freshness_lag_s "
          f"{st.get('freshness_lag_s', float('nan')):.3f} s (SLO "
          f"{st['freshness_slo_s']:g} s), scraped {lag} [{card}]")
    print(f"22c K1: loop_trainer {k1_train} launches ({2 * steps} = 2 x "
          f"{steps} train forwards), loop_replicas {k1_serve} [{card}]")
    gates = {
        "3 promotions while training": len(during) >= 3,
        "only the degraded and the poisoned versions rejected":
            st["canary_rejections"] == 2 and rejected == bad_versions,
        "the promotions improved on the boot model": bool(promoted) and
            promoted[-1][3] >= promoted[0][2] + L["gain"],
        "no admitted request lost": lost == 0 and sent[0] > 0,
        "the torn publish invisible, then published again":
            pst["torn_publishes"] == 1 and len(torn) == 1
            and torn[0] in [v["version"] for v in visible],
        "the bad versions invisible":
            all(v["version"] not in bad_versions for v in visible),
        "the bad versions never past their canary":
            rstats[other]["version"] == other_v,
        "the fleet serves the incumbent": bool(promoted) and
            abs(served - promoted[-1][3]) <= 1e-4,
        "freshness within the SLO and scraped":
            bool(lag) and max(lag) <= st["freshness_slo_s"],
        "K1 on both paths": k1_train == 2 * steps and k1_serve > 0}
    failed = [k for k, v in gates.items() if not v]
    check(not failed, f"22c: gates failed: {failed}")
    return {"promotions": len(promoted), "during": len(during),
            "rejected": rejected, "sent": sent[0], "lost": lost,
            "lag": st.get("freshness_lag_s"), "k1_train": k1_train,
            "k1_serve": k1_serve, "s": time.perf_counter() - t_phase}


def guardian_phase(card, workdir):
    """Phase 22: the training guardian (22a, 22b) and the train-to-serve
    loop (22c); 22d's K1 counts go into the kernels line."""
    import incubator_mxnet_tpu_torch as mx
    out, times = {}, {}
    saved = {k: os.environ.get(k) for k in GUARD22_ENV}
    os.environ.update(GUARD22_ENV)
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    try:
        t0 = time.perf_counter()
        out["22a"] = guard22_mlp(mx, card, workdir)
        times["22a"] = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        t0 = time.perf_counter()
        out["22b"] = guard22_alexnet(mx, card)
        times["22b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["22c"] = loop22(mx, card, workdir)
        times["22c"] = time.perf_counter() - t0
    finally:
        os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
    out["times"] = times
    out["k1"] = {"guardian_fit": out["22a"]["launches"],
                 "alexnet_guarded": out["22b"]["launches"],
                 "loop_trainer": out["22c"]["k1_train"],
                 "loop_replicas": out["22c"]["k1_serve"]}
    return out

# -- phase 23: the elastic supervisor, the collective plane, failover -------

# 23a: the collective plane (MXNET_KVSTORE_COLLECTIVE unset: on) in
# COLL23_WORKERS worker processes started by the port's launcher.  The
# mlp lane is 14c's (8 steps, batch 32 a worker, SGD on the workers);
# the AlexNet lane is 17b's model (Dropout 0.5, Xavier, OPT17) in fp32,
# batch ALEX23["batch"] / COLL23_WORKERS a worker, `warm` steps and then
# `timed` steps
COLL23_WORKERS = 2
ALEX23 = dict(batch=128, warm=2, timed=4)
# 23b: one worker fitting the mlp with a snapshot a batch over 2 epochs
# of 6 batches of 64; the server crashes at the end of batch 7 and an
# empty one takes its port; failover diagnosed in well under a second
FAIL23 = dict(batches=6, epochs=2, kill_at=7)
FAIL23_ENV = {"MXNET_PS_RECONNECT_WAIT": "0.2", "MXNET_PS_MAX_RETRIES": "2",
              "MXNET_PS_BREAKER_THRESHOLD": "2"}
# 23c: 3 pod workers (dist.pod_worker, train_mnist's mlp at batch 32, 6
# batches an epoch, 2 epochs, the socket plane), rank 2 killed at its 4th
# step; the pod's clocks (the coordinator reads them in this process)
POD23 = dict(workers=3, kill_rank=2, kill_at=4, batch=32, batches=6)
POD23_CLOCKS = {"MXNET_SUPERVISOR_HEARTBEAT_S": "0.2",
                "MXNET_SUPERVISOR_DEADLINE_S": "1.0",
                "MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S": "5.0",
                "MXNET_SUPERVISOR_SHRINK_BARRIER_S": "10.0",
                "MXNET_PS_RECONNECT_WAIT": "1.0"}
# 23d: gluon.Trainer on [gpu(0), gpu(0)], AlexNet (Dropout 0) bf16 with
# fp32 master weights, half of each batch of 128 a context, 4 steps
TRAINER23 = dict(batch=128, steps=4)
# 23d: each step's displacement of the fp32 masters, two replicas from
# one context's state against that context at the whole batch (rtol,
# atol * max|displacement|), outside the fc6/fc7 units whose ReLU flipped
# between M = 64 and M = 128: each replica's bf16 gradient and their
# bf16 sum are rounded (2**-8 relative each) where one context rounds
# the whole batch's once.  Not PARITY_TOL on the masters: a bias starts
# at 0, so its master is all displacement (0.4-0.6 % off after a step on
# the CPU at batch 4); not free running: from the second step a master 1
# ulp apart rounds to another bf16 weight (7.8x this tolerance after two
# steps on the CPU); and not over the flipped units, whose gradients
# moved by 3.1 % of the largest at fc7 on an H100 (3 units of 4096)
TRAINER23_TOL = (2 ** -6, 2 ** -6)


def env23(updates):
    """Set `updates` in os.environ; returns what to restore."""
    saved = {k: os.environ.get(k) for k in updates}
    for k, v in updates.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return saved


def params_sha(args):
    """sha256 over the sorted parameters' bytes."""
    import hashlib
    return hashlib.sha256(b"".join(
        args[k].asnumpy().tobytes() for k in sorted(args))).hexdigest()


def coll23_worker():
    """One 23a worker (started by the port's launcher on the card): the
    mlp lane through Module.fit(kvstore='dist_sync') on the collective
    plane from DIST_OUT's initial parameters, then AlexNet in fp32 at
    half of ALEX23's batch.  Writes the parameters, K1's launches, the
    plane's dispatches and all-reduce timings to DIST_OUT."""
    marks = [time.time()]
    import incubator_mxnet_tpu_torch as mx
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out_dir = os.environ["DIST_OUT"]
    rank = int(os.environ["DMLC_RANK"])
    per = TRAIN_BATCH // COLL23_WORKERS
    x, y = dist_data(mx)
    rows = dist_rows(rank, COLL23_WORKERS)
    init = dict(np.load(os.path.join(out_dir, "init.npz")))
    result = {}
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.gpu(0))
    ticks = []
    fc_relu.launches = 0
    mod.fit(mx.io.NDArrayIter(x[rows], y[rows], per), num_epoch=1,
            kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": TRAIN_MOMENTUM},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in init.items()},
            batch_end_callback=lambda p: ticks.append(time.perf_counter()))
    kv, plane = mod._kvstore, mod._kvstore._collective
    check(plane is not None, "23a: the collective plane did not form")
    args, _ = mod.get_params()
    np.savez(os.path.join(out_dir, f"mlp{rank}.npz"),
             **{k: v.asnumpy() for k, v in args.items()})
    server = kv.server_metrics()[0]
    result["mlp"] = {
        "launches": fc_relu.launches, "steps": len(ticks),
        "keys": len(mod._exec_group.param_names),
        "dispatches": plane.dispatch_count, "backend": plane.backend,
        "wire_bytes": kv.wire_bytes, "server_pushes": server["pushes"],
        "server_updates": server["updates"], "rescale":
            mod._optimizer.rescale_grad}
    kv.close(send_stop=False)
    marks.append(time.time())
    batch, warm, timed = (ALEX23[k] for k in ("batch", "warm", "timed"))
    _, sym = alex_symbol(mx, DROP_RATE)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    ticks = []

    def tick(p):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())
    fc_relu.launches = 0
    mx.random.seed(SEED)
    mod.fit(resident_iter(mx, batch // COLL23_WORKERS, "float32",
                          warm + timed, seed=SEED + 23 + rank),
            num_epoch=1, kvstore="dist_sync", optimizer="sgd",
            optimizer_params=dict(OPT17), initializer=resnet_init(mx),
            batch_end_callback=tick)
    kv, plane = mod._kvstore, mod._kvstore._collective
    args, _ = mod.get_params()
    total = sum(int(v.size) * 4 for v in args.values())
    steps = [(b, s) for b, s in plane.timings if b == total]
    result["alexnet"] = {
        "launches": fc_relu.launches, "steps": len(ticks),
        "sha": params_sha(args), "bytes": total,
        "allreduce_s": [s for _, s in steps[-timed:]],
        "step_s": (ticks[-1] - ticks[warm - 1]) / timed,
        "finite": all(bool(np.isfinite(v.asnumpy()).all())
                      for v in args.values()),
        "wire_bytes": kv.wire_bytes}
    # one stop a worker: the launcher's server stops once both sent it
    kv.close()
    result["marks"] = marks + [time.time()]
    with open(os.path.join(out_dir, f"result{rank}.json"), "w") as f:
        json.dump(result, f)
    print(f"coll23 worker {rank} OK", flush=True)


def coll23(mx, card, workdir, alex_images_s):
    """23a: the port's launcher starts COLL23_WORKERS workers on the card
    with MXNET_KVSTORE_COLLECTIVE unset.  The mlp lane: the workers'
    parameters equal bit for bit and within DP_TOL of one process fitting
    the global batch on the card; one all-reduce a step (one dtype
    bucket) after the keys' init; no gradient byte on the server; K1
    twice a step in each worker.  The AlexNet lane: per step, the
    all-reduce's ms, its bytes, the GB/s through gloo, and steps/s."""
    sym = mlp_symbol(mx)
    init = dp_init(mx, sym)
    t0, wall0 = time.perf_counter(), time.time()
    with tempfile.TemporaryDirectory(dir=workdir) as out:
        np.savez(os.path.join(out, "init.npz"), **init)
        env = dict(os.environ, DIST_OUT=out, MXNET_PS_REQUEST_TIMEOUT="300",
                   MXNET_SUBGRAPH_BACKEND="TPU_PALLAS")
        env.pop("MXNET_KVSTORE_COLLECTIVE", None)
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.run(
            [sys.executable, "-m", "incubator_mxnet_tpu_torch.dist.launch",
             "-n", str(COLL23_WORKERS), sys.executable, "-c",
             "import chip_smoke; chip_smoke.coll23_worker()"],
            cwd=here, env=env, capture_output=True, text=True, timeout=600)
        tail = (proc.stdout + proc.stderr)[-3000:]
        check(proc.returncode == 0, f"23a: the launched job failed "
              f"(rc {proc.returncode}):\n{tail}")
        res = [json.load(open(os.path.join(out, f"result{r}.json")))
               for r in range(COLL23_WORKERS)]
        params = [dict(np.load(os.path.join(out, f"mlp{r}.npz")))
                  for r in range(COLL23_WORKERS)]
    launch_s = time.perf_counter() - t0
    marks = [[m - wall0 for m in r["marks"]] for r in res]
    print("23a timeline: worker started, its mlp lane done, its AlexNet "
          "lane done, s after the launch: "
          + "; ".join(", ".join(f"{m:.1f}" for m in w) for w in marks))
    x, y = dist_data(mx)
    mod = mx.mod.Module(sym, context=mx.gpu(0))
    mod.fit(mx.io.NDArrayIter(x, y, TRAIN_BATCH), num_epoch=1,
            optimizer="sgd", optimizer_params={"learning_rate": TRAIN_LR,
                                               "momentum": TRAIN_MOMENTUM},
            arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                        for k, v in init.items()})
    want = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    same = all(np.array_equal(params[0][k], p[k])
               for p in params[1:] for k in want)
    pw, pn = held_worst(params[0], want, DP_TOL)
    mlp = [r["mlp"] for r in res]
    gates = {
        "workers equal bit for bit": same,
        "within DP_TOL of one process": pw <= 1,
        "the collective plane, gloo": all(m["backend"] == "gloo"
                                          for m in mlp),
        "one all-reduce a step after the keys' init": all(
            m["steps"] == DIST_STEPS and
            m["dispatches"] == m["keys"] + DIST_STEPS for m in mlp),
        "no gradient byte on the server": all(
            m["wire_bytes"] == 0 and m["server_pushes"] == 0 and
            m["server_updates"] == 0 for m in mlp),
        "rescale 1 / global batch": all(
            m["rescale"] == 1.0 / TRAIN_BATCH for m in mlp),
        "K1 twice a step": all(m["launches"] == 2 * DIST_STEPS
                               for m in mlp)}
    print(f"23a collective plane: {COLL23_WORKERS} workers x batch "
          f"{TRAIN_BATCH // COLL23_WORKERS} of train_mnist's mlp, "
          f"Module.fit(kvstore='dist_sync') {DIST_STEPS} steps through the "
          f"launcher ({launch_s:.1f} s with process starts, both lanes): "
          f"workers equal bit for bit {same}; vs one process at batch "
          f"{TRAIN_BATCH} at {pw:.3f} of DP_TOL (worst {pn}); dispatches "
          f"{[m['dispatches'] for m in mlp]} = {mlp[0]['keys']} keys' init "
          f"+ {DIST_STEPS} steps; server pushes "
          f"{[m['server_pushes'] for m in mlp]}, wire bytes "
          f"{[m['wire_bytes'] for m in mlp]}; K1 launches "
          f"{[m['launches'] for m in mlp]} [{card}]")
    alex = [r["alexnet"] for r in res]
    steps = ALEX23["warm"] + ALEX23["timed"]
    ar_ms = [1e3 * statistics.median(a["allreduce_s"]) for a in alex]
    nbytes = alex[0]["bytes"]
    step_s = max(a["step_s"] for a in alex)
    images_s = ALEX23["batch"] / step_s
    gates.update({
        "AlexNet workers equal bit for bit": len({a["sha"] for a in alex})
        == 1,
        "AlexNet finite": all(a["finite"] for a in alex),
        "AlexNet one bucket a step": all(
            len(a["allreduce_s"]) == ALEX23["timed"] for a in alex),
        "AlexNet K1 twice a step": all(a["launches"] == 2 * steps
                                       for a in alex)})
    for i, a in enumerate(alex):
        print(f"23a alexnet worker {i}: all-reduce per timed step "
              + ", ".join(f"{1e3 * s:.2f}" for s in a["allreduce_s"])
              + f" ms of {nbytes} bytes (one fp32 bucket) = "
              + ", ".join(f"{nbytes / s / 1e9:.3f}" for s in
                          a["allreduce_s"])
              + f" GB/s through gloo; step {1e3 * a['step_s']:.2f} ms; K1 "
              f"{a['launches']} launches [{card}]")
    print(f"23a alexnet: fp32, batch {ALEX23['batch']} = "
          f"{COLL23_WORKERS} x {ALEX23['batch'] // COLL23_WORKERS}, "
          f"{1 / step_s:.2f} steps/s = {images_s:.1f} images/s against "
          f"17b's one process {alex_images_s:.1f} images/s (bf16, batch "
          f"{ALEX_LANE['batch']}): {images_s / alex_images_s:.3f}; "
          f"all-reduce median {statistics.median(ar_ms):.2f} ms = "
          f"{nbytes / statistics.median(ar_ms) / 1e6:.3f} GB/s [{card}]")
    failed = [k for k, v in gates.items() if not v]
    check(not failed, f"23a: gates failed: {failed}")
    return {"launches": sum(m["launches"] for m in mlp)
            + sum(a["launches"] for a in alex),
            "allreduce_ms": statistics.median(ar_ms), "bytes": nbytes,
            "gb_s": nbytes / statistics.median(ar_ms) / 1e6,
            "steps_s": 1 / step_s, "images_s": images_s,
            "dp_worst": pw, "dispatches": mlp[0]["dispatches"]}


def fail23_fit(mx, server, data, ckpt=None, kill_at=None):
    """One worker's dist_sync fit of train_mnist's mlp on the card
    against `server` (FAIL23, a snapshot a batch with `ckpt`).  With
    `kill_at` the server crashes at that batch end and an empty one
    takes its port.  -> (params sha256, batch-end times, crash time,
    replacement servers, K1 launches)."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    x, y = data
    mx.random.seed(SEED)
    np.random.seed(SEED)
    mod = mx.mod.Module(mlp_symbol(mx), context=mx.gpu(0))
    ends, crash, replacement = [], [], []
    cls, port = type(server), server.port

    def cb(p):
        ends.append(time.perf_counter())
        if kill_at is not None and len(ends) == kill_at:
            crash.append(time.perf_counter())
            server._simulate_crash()
            for _ in range(200):
                try:
                    srv = cls(host="127.0.0.1", port=port, num_workers=1)
                    break
                except OSError:
                    time.sleep(0.05)
            replacement.append(srv.start())
    fc_relu.launches = 0
    mod.fit(mx.io.NDArrayIter(x, y, TRAIN_BATCH, shuffle=False),
            kvstore="dist_sync", optimizer="sgd",
            optimizer_params={"learning_rate": TRAIN_LR,
                              "momentum": TRAIN_MOMENTUM},
            num_epoch=FAIL23["epochs"], checkpoint_dir=ckpt,
            checkpoint_period=1, batch_end_callback=cb)
    launches = fc_relu.launches
    sha = params_sha(mod.get_params()[0])
    mod._kvstore.close()
    return sha, ends, crash, replacement, launches


def fail23(mx, card, workdir):
    """23b: the card's form of the JAX gate
    `test_killed_server_fit_auto_resumes_bit_identical`: a clean
    one-worker dist_sync fit, then the same fit whose server is crashed
    mid-epoch and replaced empty on the same port; fit raises
    ServerLostError inside, restarts from the last checkpoint and ends
    sha256-equal to the clean run."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    x, y = dist_data(mx)
    n = FAIL23["batches"] * TRAIN_BATCH
    data = (x[:n], y[:n])
    steps = FAIL23["batches"] * FAIL23["epochs"]
    servers = []
    saved = env23(dict(FAIL23_ENV, DMLC_PS_ROOT_URI="127.0.0.1",
                       DMLC_RANK="0", DMLC_NUM_WORKER="1",
                       DMLC_NUM_SERVER="1", DMLC_PS_ROOT_PORT=None,
                       MXNET_SUBGRAPH_BACKEND="TPU_PALLAS"))
    root = tempfile.mkdtemp(dir=workdir, prefix="fail23-")
    try:
        clean = ParameterServer(num_workers=1).start()
        servers.append(clean)
        os.environ["DMLC_PS_ROOT_PORT"] = str(clean.port)
        sha_clean, ends_clean, _, _, k1_clean = fail23_fit(mx, clean, data)
        server = ParameterServer(num_workers=1).start()
        servers.append(server)
        os.environ["DMLC_PS_ROOT_PORT"] = str(server.port)
        sha, ends, crash, repl, k1 = fail23_fit(
            mx, server, data, ckpt=os.path.join(root, "ck"),
            kill_at=FAIL23["kill_at"])
        servers += repl
    finally:
        for s in servers:
            s.shutdown()
        env23(saved)
        shutil.rmtree(root, ignore_errors=True)
    resumed = [t for t in ends if crash and t > crash[0]]
    gates = {"the kill ran": bool(crash) and bool(repl),
             "sha256-equal to the clean run": sha == sha_clean,
             "the clean run took every step": len(ends_clean) == steps,
             "K1 twice a forward": k1_clean == 2 * steps and
             k1 == 2 * len(ends)}
    first_s = resumed[0] - crash[0] if resumed else float("nan")
    print(f"23b lost server: one worker, train_mnist's mlp, "
          f"{FAIL23['epochs']} epochs of {FAIL23['batches']} batches of "
          f"{TRAIN_BATCH}, a snapshot a batch; the server crashed at the "
          f"end of batch {FAIL23['kill_at']} and replaced empty on its "
          f"port: {len(ends)} batch ends (the clean run {len(ends_clean)}),"
          f" first resumed step {first_s:.3f} s after the crash; params "
          f"sha256 {sha[:16]} vs clean {sha_clean[:16]} "
          f"{'equal' if sha == sha_clean else 'DIFFER'}; K1 {k1} launches "
          f"[{card}]")
    failed = [k for k, v in gates.items() if not v]
    check(not failed, f"23b: gates failed: {failed}")
    return {"launches": k1 + k1_clean, "resume_s": first_s,
            "batches": len(ends)}


def pod23_run(port, n, ckpt, kill=None, resume=False):
    """`dist.pod_worker` in `n` processes on the card against the
    coordinator on `port`: -> (processes, outputs)."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("DMLC_RANK", "MXNET_FAULTS",
                        "MXNET_SUPERVISOR_EPOCH")}
    env.update(POD23_CLOCKS, DMLC_PS_ROOT_URI="127.0.0.1",
               DMLC_PS_ROOT_PORT=str(port), DMLC_NUM_WORKER=str(n),
               DMLC_ROLE="worker", MXNET_KVSTORE_COLLECTIVE="0",
               MXNET_SUBGRAPH_BACKEND="TPU_PALLAS", POD_MODEL="mlp",
               POD_DEVICE="gpu", POD_BATCH=str(POD23["batch"]),
               POD_BATCHES=str(POD23["batches"]), POD_CKPT_DIR=ckpt,
               POD_RESUME="1" if resume else "0",
               MXNET_PS_REQUEST_TIMEOUT="120")
    here = os.path.dirname(os.path.abspath(__file__))
    procs, spawned = [], time.time()
    for r in range(n):
        wenv = dict(env, DMLC_RANK=str(r))
        if kill is not None and r == kill[0]:
            wenv["MXNET_FAULTS"] = f"seed=23;host.step:kill(at={kill[1]})"
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "incubator_mxnet_tpu_torch.dist.pod_worker"], cwd=here,
            env=wenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    steps = [float(line.split()[4]) for o in outs for line in o.splitlines()
             if line.startswith("STEP ")]
    if steps:
        print(f"23c timeline ({n} workers): first step "
              f"{min(steps) - spawned:.1f} s after the spawn, the last "
              f"{max(steps) - spawned:.1f} s, all exited "
              f"{time.time() - spawned:.1f} s")
    return procs, outs


def pod23_line(out, key):
    m = re.search(rf"^{key} (.*)$", out, re.M)
    return m.group(1) if m else None


def pod23(mx, card, workdir):
    """23c: the JAX pod gate on the card: 3 pod workers fitting the mlp,
    rank 2 SIGKILLed at its 4th step.  The survivors see it dead within
    the deadline + 2 s, their stalled round raises CollectiveTimeoutError
    naming [2], they shrink to world 2 at epoch 1 and resume; their
    PARAMS_SHA equals a 2-worker control resumed from the same
    checkpoint."""
    from incubator_mxnet_tpu_torch.dist.server import ParameterServer
    root = tempfile.mkdtemp(dir=workdir, prefix="pod23-")
    ckpt, control = os.path.join(root, "ck"), os.path.join(root, "control")
    saved = env23(POD23_CLOCKS)
    try:
        server = ParameterServer(num_workers=POD23["workers"]).start()
        try:
            procs, outs = pod23_run(server.port, POD23["workers"], ckpt,
                                    kill=(POD23["kill_rank"],
                                          POD23["kill_at"]))
        finally:
            server.shutdown()
        survivors = [r for r in range(POD23["workers"])
                     if r != POD23["kill_rank"]]
        for r in survivors:
            check(procs[r].returncode == 0 and "worker OK" in outs[r],
                  f"23c: survivor {r} failed (rc {procs[r].returncode}):\n"
                  f"{outs[r][-3000:]}")
        m = re.search(r"resuming from .*\(step (\d+),", outs[survivors[0]])
        check(m is not None, "23c: no resume line")
        resume_step = int(m.group(1))
        shutil.copytree(ckpt, control)
        for entry in os.listdir(control):
            cm = re.match(r"ckpt-(\d+)$", entry)
            if cm and int(cm.group(1)) > resume_step:
                shutil.rmtree(os.path.join(control, entry))
        server = ParameterServer(num_workers=len(survivors)).start()
        try:
            cprocs, couts = pod23_run(server.port, len(survivors), control,
                                      resume=True)
        finally:
            server.shutdown()
    finally:
        env23(saved)
    for r, p in enumerate(cprocs):
        check(p.returncode == 0, f"23c: control worker {r} failed "
              f"(rc {p.returncode}):\n{couts[r][-3000:]}")
    killed = outs[POD23["kill_rank"]]
    last_step = max((float(line.split()[4]) for line in killed.splitlines()
                     if line.startswith("STEP ")), default=float("nan"))
    deadline = float(POD23_CLOCKS["MXNET_SUPERVISOR_DEADLINE_S"])
    detect, shrink_s, restart, k1 = [], [], [], []
    for r in survivors:
        o = outs[r]
        found = [f for f in json.loads(pod23_line(o, "FINDINGS") or "[]")
                 if f["code"] == "host-lost"]
        detect.append(found[0]["time"] - last_step if found
                      else float("inf"))
        sh = json.loads(pod23_line(o, "SHRINK") or "{}")
        shrink_s.append(sh.get("seconds", float("nan")))
        after = [float(line.split()[4]) for line in o.splitlines()
                 if line.startswith("STEP ") and sh.get("ended") and
                 float(line.split()[4]) > sh["ended"]]
        restart.append(after[0] - sh["ended"] if after else float("nan"))
        k1.append(int(pod23_line(o, "K1") or -1))
    stats = [json.loads(pod23_line(outs[r], "SUPSTATS") or "{}")
             for r in survivors]
    chaos = {pod23_line(outs[r], "PARAMS_SHA") for r in survivors}
    ctrl = {pod23_line(o, "PARAMS_SHA") for o in couts}
    steps_run = [sum(line.startswith("STEP ") for line in outs[r]
                     .splitlines()) for r in survivors]
    gates = {
        "the killed host exited 137": procs[POD23["kill_rank"]].returncode
        == 137,
        "death seen within the deadline + 2 s": all(
            d <= deadline + 2.0 for d in detect),
        "CollectiveTimeoutError naming [2]": all(
            re.search(r"host\(s\) \[2\] failed to arrive", outs[r])
            for r in survivors),
        "shrunk to world 2 at epoch 1": all(
            "pod shrunk to world_size=2" in outs[r] for r in survivors)
        and all(s.get("epoch") == 1 and s.get("world_size") == 2
                for s in stats),
        "PARAMS_SHA equal to the control's": len(chaos) == 1 and
        None not in chaos and chaos == ctrl,
        "no COMPILES line": not any("COMPILES" in o for o in outs + couts),
        # the stalled step's forward ran too: its round never completed
        "K1 twice a forward in every survivor": all(
            k == 2 * (n + 1) for k, n in zip(k1, steps_run))}
    print(f"23c lost host: {POD23['workers']} pod workers (train_mnist's "
          f"mlp, batch {POD23['batch']}, the socket plane, heartbeat "
          f"{POD23_CLOCKS['MXNET_SUPERVISOR_HEARTBEAT_S']} s, deadline "
          f"{deadline:g} s, watchdog "
          f"{POD23_CLOCKS['MXNET_SUPERVISOR_COLLECTIVE_TIMEOUT_S']} s), "
          f"rank {POD23['kill_rank']} killed at its step "
          f"{POD23['kill_at']}: seen dead "
          + ", ".join(f"{d:.3f}" for d in detect)
          + " s after its last step; shrink barrier "
          + ", ".join(f"{s:.3f}" for s in shrink_s)
          + " s; first resumed step "
          + ", ".join(f"{s:.3f}" for s in restart)
          + f" s after the commit; resumed from step {resume_step}; "
          f"PARAMS_SHA {'equal' if chaos == ctrl else 'DIFFER'} to the "
          f"2-worker control; K1 {k1} launches over {steps_run} steps and "
          f"the stalled one [{card}]")
    shutil.rmtree(root, ignore_errors=True)
    failed = [k for k, v in gates.items() if not v]
    check(not failed, f"23c: gates failed: {failed}\n"
          + "\n".join(o[-1500:] for o in outs))
    return {"launches": sum(k1), "detect_s": max(detect),
            "shrink_s": max(shrink_s), "restart_s": max(restart)}


def trainer23_graph(mx):
    """AlexNet (Dropout 0) partitioned under TPU_PALLAS: K1 at fc6, fc7."""
    return mx.subgraph.partition_graph(
        alex_net(mx, 0.0)(mx.sym.Variable("data")), "TPU_PALLAS")


def trainer23_block(mx, values, ctxs, grad_req="write", outputs=None):
    """The partitioned AlexNet (or its `outputs`) as a SymbolBlock on
    `ctxs` holding `values`, in bf16."""
    net = mx.gluon.SymbolBlock(outputs if outputs is not None else
                               trainer23_graph(mx), mx.sym.Variable("data"))
    for name, p in net.collect_params().items():
        p.initialize(ctx=ctxs)
        p.set_data(values[name])
        p.grad_req = grad_req
    net.cast("bfloat16")
    return net


def trainer23_lane(mx, values, ctxs, split, grad_req="write"):
    net = trainer23_block(mx, values, ctxs, grad_req)
    return {"net": net, "ctxs": ctxs, "split": split, "k1": 0,
            "reduce_ms": [], "trainer": mx.gluon.Trainer(
                net.collect_params(), "sgd",
                dict(OPT17, multi_precision=True))}


def trainer23_step(mx, lane, x, y, loss_fn):
    """One step of a 23d lane: each of `split` shares of the batch on its
    replica (under `replica`; one context accumulates them with
    ``grad_req='add'``), then the batched reduce (timed,
    CUDA-synchronised) and the update; K1's launches added up."""
    from incubator_mxnet_tpu_torch.gluon.parameter import replica
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    ctxs, net, trainer = lane["ctxs"], lane["net"], lane["trainer"]
    if lane["split"] > len(ctxs):
        for p in net.collect_params().values():
            p.zero_grad()
    fc_relu.launches = 0
    for k, (xk, yk) in enumerate(zip(np.split(x, lane["split"]),
                                     np.split(y, lane["split"]))):
        c = k % len(ctxs)
        data = mx.nd.array(xk, ctx=ctxs[c]).astype("bfloat16")
        label = mx.nd.array(yk, ctx=ctxs[c])
        with replica(c), mx.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
    lane["k1"] += fc_relu.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.allreduce_grads()
    torch.cuda.synchronize()
    lane["reduce_ms"].append((time.perf_counter() - t0) * 1e3)
    trainer.update(x.shape[0])


def trainer23_state(lane):
    """({name: bf16 weights of every copy}, {name: fp32 master},
    {name: momentum}) of a 23d lane's first replica, as numpy."""
    states = lane["trainer"]._updaters[0].states
    params = lane["net"].collect_params()
    copies = {n: [d.asnumpy() for d in p.list_data()]
              for n, p in params.items()}
    return (copies, {n: states[i][1].asnumpy() for i, n in enumerate(params)},
            {n: states[i][0].asnumpy() for i, n in enumerate(params)})


def trainer23_teach(two, one):
    """Every replica of `two` takes `one`'s weights, masters and momenta
    (11a's teacher: each step starts from the reference's state)."""
    ref = one["trainer"]._updaters[0].states
    pairs = zip(two["net"].collect_params().values(),
                one["net"].collect_params().values())
    for i, (p, q) in enumerate(pairs):
        for k, upd in enumerate(two["trainer"]._updaters):
            p.list_data()[k]._set_data(q.data().data)
            upd.states[i] = tuple(None if t is None else t.copy()
                                  for t in ref[i])


def trainer23_flips(mx, values, x):
    """{weight or bias name: mask} of fc6's and fc7's units whose ReLU
    output is 0 for some image at M = 64 (the replicas' halves) and not
    at M = 128 (one context), or the reverse, with the weights `values`
    (fp32 numpy, cast to bf16 as the lanes hold them): K1
    rounds to bf16 in other orders at the two M, and a unit at its kink
    flips (phase 17a's excuse of a flipped max-pool window, for ReLU)."""
    graph = trainer23_graph(mx)
    internals = graph.get_internals()
    names = internals.list_outputs()
    k1 = [i for i, n in enumerate(names) if n == "fwd_tpu_pallas_output"]
    check(len(k1) == 2, f"23d: {len(k1)} K1 outputs in the graph")
    outs = mx.sym.Group([internals[i] for i in k1])
    block = trainer23_block(mx, values, [mx.gpu(0)], "null", outs)
    acts = {}
    for m in (x.shape[0] // 2, x.shape[0]):
        got = [block(mx.nd.array(xk, ctx=mx.gpu(0)).astype("bfloat16"))
               for xk in np.split(x, x.shape[0] // m)]
        acts[m] = [np.concatenate([g[j].astype("float32").asnumpy()
                                   for g in got]) for j in range(2)]
    mask = {}
    for j, layer in enumerate(("dense0", "dense1")):
        a, b = acts[x.shape[0] // 2][j], acts[x.shape[0]][j]
        units = ((a > 0) != (b > 0)).any(axis=0)
        w = f"{ALEX_PREFIX}{layer}_weight"
        mask[w] = np.repeat(units[:, None], values[w].shape[1], axis=1)
        mask[f"{ALEX_PREFIX}{layer}_bias"] = units
    return mask


def trainer23(mx, card):
    """23d: gluon.Trainer over AlexNet's parameters on [gpu(0), gpu(0)]
    (two replicas on the one card, each forward under
    `gluon.parameter.replica`), half of each batch a replica, through the
    bucketed store at the default cap.  Free running, TRAINER23's steps
    equal bit for bit (weights of both copies, masters, momenta) one
    context accumulating the same two halves; each step from one
    context's state at the whole batch, the fp32 masters' displacement
    within TRAINER23_TOL outside the fc6/fc7 units whose ReLU flipped
    (counted); one reduction a bucket each step; K1 at fc6, fc7."""
    batch, steps = TRAINER23["batch"], TRAINER23["steps"]
    alex_k1_held(batch // 2, BF16, "23d")
    alex_k1_held(batch, BF16, "23d")
    ref = alex_net(mx, 0.0)
    mx.random.seed(SEED)
    ref.initialize(resnet_init(mx), ctx=mx.cpu())
    ref(mx.nd.zeros((1,) + IMAGE, ctx=mx.cpu()))
    values = {n: p.data().asnumpy() for n, p in
              ref.collect_params().items()}
    rng = np.random.RandomState(SEED + 230)
    batches = [(rng.rand(batch, *IMAGE).astype("f4"),
                rng.randint(0, CLASSES, batch).astype("f4"))
               for _ in range(steps)]
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    two2 = [mx.gpu(0), mx.gpu(0)]
    free = trainer23_lane(mx, values, two2, 2)
    halves = trainer23_lane(mx, values, [mx.gpu(0)], 2, "add")
    taught = trainer23_lane(mx, values, two2, 2)
    whole = trainer23_lane(mx, values, [mx.gpu(0)], 1)
    before, worst, flips, stats = values, (0.0, "none"), [], []
    for step, (x, y) in enumerate(batches):
        if step:
            trainer23_teach(taught, whole)
        cur = values if not step else {
            n: p.data().astype("float32").asnumpy()
            for n, p in whole["net"].collect_params().items()}
        mask = trainer23_flips(mx, cur, x)
        flips.append(int(sum(m.sum() for n, m in mask.items()
                             if n.endswith("_bias"))))
        for lane in (free, halves, taught, whole):
            trainer23_step(mx, lane, x, y, loss_fn)
        stats.append(dict(free["trainer"]._kvstore.stats()))
        got = trainer23_state(taught)[1]
        want = trainer23_state(whole)[1]
        w = held_worst({n: got[n] - before[n] for n in want},
                       {n: want[n] - before[n] for n in want},
                       TRAINER23_TOL,
                       keep={n: ~mask[n] if n in mask else
                             np.ones(want[n].shape, bool) for n in want})
        worst = max(worst, (w[0], f"{w[1]} at step {step + 1}"))
        before = want
    torch.cuda.synchronize()
    a, b = trainer23_state(free), trainer23_state(halves)
    bitwise = all(
        all(np.array_equal(c, b[0][n][0]) for c in a[0][n]) and
        np.array_equal(a[1][n], b[1][n]) and np.array_equal(a[2][n], b[2][n])
        for n in b[1])
    zero = {"buckets": 0, "allreduce_dispatches": 0}
    buckets = [q["buckets"] - p["buckets"]
               for p, q in zip([zero] + stats[:-1], stats)]
    dispatches = [q["allreduce_dispatches"] - p["allreduce_dispatches"]
                  for p, q in zip([zero] + stats[:-1], stats)]
    fill = stats[-1]["avg_bucket_fill"]
    gates = {"two replicas = one context over the halves, bit for bit":
             bitwise,
             "each step's displacement within TRAINER23_TOL": worst[0] <= 1,
             "one reduction a bucket each step": dispatches == buckets
             and all(n == buckets[0] and n > 0 for n in buckets),
             "one batched push a step":
             stats[-1]["batched_pushes"] == steps,
             "K1 twice a replica's forward": free["k1"] == 2 * 2 * steps
             and whole["k1"] == 2 * steps}
    print(f"23d gluon.Trainer on [gpu(0), gpu(0)]: AlexNet bf16 (fp32 "
          f"masters), batch {batch} = 2 x {batch // 2}, {steps} steps "
          f"through kvstore 'device' at "
          f"{stats[-1]['bucket_cap_mb']:g} MB buckets: {buckets[0]} "
          f"buckets a step, mean fill {fill:.3f}, reductions {dispatches};"
          f" reduce " + ", ".join(f"{ms:.3f}" for ms in free["reduce_ms"])
          + f" ms a step; free running, weights, masters and momenta "
          f"{'equal' if bitwise else 'NOT equal'} bit for bit to one "
          f"context over the same halves; each step from one context's "
          f"state at batch {batch}: the masters' displacement at "
          f"{worst[0]:.3f} of the tolerance (rtol {TRAINER23_TOL[0]:g}, "
          f"atol {TRAINER23_TOL[1]:g}*max; worst {worst[1]}) outside "
          f"{flips} fc6/fc7 units whose ReLU flipped between M = "
          f"{batch // 2} and {batch}; K1 {free['k1']} launches (one "
          f"context at the whole batch {whole['k1']}) [{card}]")
    out = {"launches": free["k1"], "buckets": buckets[0], "fill": fill,
           "reduce_ms": statistics.median(free["reduce_ms"]),
           "worst": worst[0], "flips": sum(flips)}
    del free, halves, taught, whole
    gc.collect()
    failed = [k for k, v in gates.items() if not v]
    check(not failed, f"23d: gates failed: {failed}")
    return out


def elastic_phase(card, workdir, alex_images_s):
    """Phase 23: the collective plane (23a), a lost server (23b), a lost
    host (23c), the bucketed Trainer over two replicas (23d); the K1
    counts of each go into the kernels line."""
    import incubator_mxnet_tpu_torch as mx
    out, times = {}, {}
    for key, fn in (("23a", lambda: coll23(mx, card, workdir,
                                           alex_images_s)),
                    ("23b", lambda: fail23(mx, card, workdir)),
                    ("23c", lambda: pod23(mx, card, workdir)),
                    ("23d", lambda: trainer23(mx, card))):
        t0 = time.perf_counter()
        out[key] = fn()
        times[key] = time.perf_counter() - t0
        print(f"phase {key}: {times[key]:.1f} s")
    out["times"] = times
    out["k1"] = {"dist_collective": out["23a"]["launches"],
                 "dist_failover": out["23b"]["launches"],
                 "pod_workers": out["23c"]["launches"],
                 "trainer_multi_ctx": out["23d"]["launches"]}
    return out


# -- phase 24: the small public modules and the mesh (slice 22) -----------
# 24a: AlexNet (Dropout 0) partitioned under TPU_PALLAS, fp32, batch 32,
# through a CustomOp softmax head (hand-written backward) against the
# built-in SoftmaxCrossEntropyLoss, each step from the same parameters
CUSTOM24 = dict(batch=32, steps=3, lr=1e-4)
CUSTOM24_TOL = (1e-5, 1e-6)      # gradients: rtol, atol * max|array|
# 24b: one group of 4 gloo ranks sharing the card; the tentpole lane:
# AlexNet at full width on dp=2 x tp=2, fc6/fc7 column-parallel over tp,
# Adam with ZeRO over dp, global batch 32 fp32, 3 steps, against one
# process at the whole batch from the same parameters
WORLD24 = 4
TP24 = dict(batch=32, steps=3, lr=1e-4)
TP24_LOSS_RTOL = 1e-3
TP24_TOL = (1e-3, 1e-4)          # parameters and Adam state
# an element is left out of the parameter and moment check only when both
# lanes' gradients lie within CUSTOM24_TOL of 0 (Adam moves it by ~lr
# whichever sign rounding gives it), at most this share of the elements a
# step: the older rule, one gradient near 0, left out 0.148-0.207 % (PR
# 24's final run)
TP24_EXCUSE_MAX = 0.003
# one more mesh step with cuDNN on (the convolutions' default route),
# held to one process with cuDNN on at the whole batch: loss
# TP24_LOSS_RTOL; each gradient within CUSTOM24_TOL plus this factor
# times the largest error of the same array that cuDNN gives one process
# between the dp halves of the batch (summed) and the whole batch (its
# algorithms differ by batch: 2.7e-3 of the largest conv2d1 gradient on
# the card, where the mesh's halves run)
CUDNN24_ENVELOPE = 3.0
TP24_DEADLINE_S = 300.0
# K1 on each rank's shards: fc6 and fc7's column halves at the dp half of
# the batch (phase 3 holds both: PATH_K1)
TP24_K1 = ((TP24["batch"] // 2, 9216, 2048), (TP24["batch"] // 2, 4096,
                                               2048))
BN24 = dict(batch=64, features=32, hidden=16, steps=2, lr=0.1)
BN24_TOL = (1e-4, 1e-5)
DEV24 = "cuda"


def tp24_values(mx, graph):
    """AlexNet's parameters for `graph` (He-scaled normals, biases 0.01)
    and one batch of TP24's, drawn on the card from SEED: every rank and
    the reference draw the same."""
    dev = torch.device(DEV24, 0) if DEV24 == "cuda" else torch.device("cpu")
    shapes = dict(zip(graph.list_arguments(),
                      graph.infer_shape(data=(1,) + IMAGE)[0]))
    gen = torch.Generator(device=dev).manual_seed(SEED + 240)
    values = {}
    for name in sorted(shapes):
        if name == "data":
            continue
        shape = shapes[name]
        if name.endswith("_bias"):
            values[name] = torch.full(shape, 0.01, device=dev)
        else:
            fan_in = int(np.prod(shape[1:]))
            values[name] = torch.randn(shape, generator=gen, device=dev) \
                * math.sqrt(2.0 / fan_in)
    x = torch.rand((TP24["batch"],) + IMAGE, generator=gen, device=dev)
    y = torch.randint(0, CLASSES, (TP24["batch"],), generator=gen,
                      device=dev).float()
    return values, x, y


def block24(mx, graph, values, ctx):
    """The partitioned graph as a SymbolBlock on `ctx` holding `values`."""
    net = mx.gluon.SymbolBlock(graph, mx.sym.Variable("data"))
    for name, p in net.collect_params().items():
        p.shape = tuple(values[name].shape)
        p.initialize(ctx=ctx)
        p.set_data(values[name])
    return net


def softmax24_register(mx):
    """Register ``softmax24``: a row softmax whose backward is written by
    hand, y * (g - sum(g * y)) (the port's `CustomOp`)."""

    class Softmax24(mx.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = in_data[0]
            e = mx.nd.exp(x - mx.nd.max(x, axis=1, keepdims=True))
            self.assign(out_data[0], req[0],
                        e / mx.nd.sum(e, axis=1, keepdims=True))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y, g = out_data[0], out_grad[0]
            self.assign(in_grad[0], req[0],
                        y * (g - mx.nd.sum(g * y, axis=1, keepdims=True)))

    @mx.operator.register("softmax24")
    class Softmax24Prop(mx.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Softmax24()


def custom24(mx, card):
    """24a: AlexNet with K1 at fc6/fc7 under a CustomOp softmax head and
    -log p[label], against the built-in SoftmaxCrossEntropyLoss: each of
    CUSTOM24's steps takes both heads' gradients through one forward
    (held within CUSTOM24_TOL), then steps with the custom head's.  K1
    runs 2 a forward."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    alex_k1_held(CUSTOM24["batch"], F32, "24a")
    softmax24_register(mx)
    graph = trainer23_graph(mx)
    values, x, y = tp24_values(mx, graph)
    x, y = x[:CUSTOM24["batch"]], y[:CUSTOM24["batch"]]
    net = block24(mx, graph, values, mx.gpu(0))
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": CUSTOM24["lr"]})
    builtin = mx.gluon.loss.SoftmaxCrossEntropyLoss()
    data, label = mx.nd.array(x, ctx=mx.gpu(0)), mx.nd.array(y,
                                                             ctx=mx.gpu(0))
    fc_relu.launches = 0
    with plain_conv24():
        worst, losses = custom24_steps(mx, net, trainer, builtin, data,
                                       label)
    launches = fc_relu.launches
    ok = worst[0] <= 1 and launches == 2 * CUSTOM24["steps"] and \
        all(abs(a - b) <= 1e-5 * abs(a) for a, b in losses)
    print(f"24a CustomOp head: AlexNet (TPU_PALLAS, K1 at fc6/fc7) fp32 "
          f"batch {CUSTOM24['batch']}, {CUSTOM24['steps']} SGD steps through "
          f"nd.Custom('softmax24', hand-written backward) + -log p[label] vs "
          f"SoftmaxCrossEntropyLoss through one forward, cuDNN off: "
          f"losses "
          + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
          + f"; every gradient at {worst[0]:.3f} of rtol "
          f"{CUSTOM24_TOL[0]:g} + {CUSTOM24_TOL[1]:g}*max (worst "
          f"{worst[1]}); K1 {launches} launches (2 a forward, one forward a "
          f"step for both heads) {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "24a: the CustomOp head disagrees with the built-in loss")
    return launches


class plain_conv24:
    """cuDNN off inside the scope: the convolutions run as im2col GEMMs
    in fp32 (TF32 off).  cuDNN's algorithms for AlexNet's layers err at
    ~3e-4 of the largest gradient: a head gradient scaled by (1 + 6e-8)
    moved conv2d1's weight gradient by 262x CUSTOM24_TOL on the card with
    cuDNN, 0.34x without (0.47x on the CPU; PERF.md section 6), so two
    lanes that must agree to fp32 compare with plain convolutions."""

    def __enter__(self):
        self._was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = False

    def __exit__(self, *exc):
        torch.backends.cudnn.enabled = self._was


def custom24_steps(mx, net, trainer, builtin, data, label):
    """CUSTOM24's steps of `custom24`: one forward a step, both heads on
    its output, each head's backward through it (the built-in's first,
    keeping the graph); (worst gradient, its place) and each step's
    (built-in, custom) mean loss."""
    params = net.collect_params()
    worst, losses = (0.0, "none"), []
    for step in range(CUSTOM24["steps"]):
        with mx.autograd.record():
            out = net(data)
            loss = builtin(out, label)
            probs = mx.nd.Custom(out, op_type="softmax24")
            mine = -mx.nd.log(mx.nd.pick(probs, label))
        loss.backward(retain_graph=True)
        want = {n: p.grad().asnumpy() for n, p in params.items()}
        mine.backward()
        got = {n: p.grad().asnumpy() for n, p in params.items()}
        w = held_worst(got, want, CUSTOM24_TOL)
        worst = max(worst, (w[0], f"{w[1]} at step {step + 1}"))
        losses.append((float(loss.mean().asnumpy()),
                       float(mine.mean().asnumpy())))
        trainer.step(CUSTOM24["batch"])
    return worst, losses


def bulk24(mx, card):
    """24a: AlexNet's parameters initialised on the card inside
    `engine.bulk` equal the unbulked initialisation bit for bit, moved in
    one host-to-device copy."""
    def init(bulk):
        net = alex_net(mx, 0.0)
        net.infer_shape(mx.nd.zeros((1,) + IMAGE, ctx=mx.cpu()))
        mx.random.seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if bulk:
            with mx.engine.bulk(64):
                net.initialize(resnet_init(mx), ctx=mx.gpu(0))
        else:
            net.initialize(resnet_init(mx), ctx=mx.gpu(0))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        return {n: p.data().asnumpy() for n, p in
                net.collect_params().items()}, ms

    plain, plain_ms = init(False)
    copies, staged = mx.engine.h2d_copies, mx.engine.staged_total
    bulked, bulk_ms = init(True)
    copies, staged = (mx.engine.h2d_copies - copies,
                      mx.engine.staged_total - staged)
    same = all(np.array_equal(plain[n], bulked[n]) for n in plain)
    nbytes = sum(v.nbytes for v in plain.values())
    ok = same and copies == 1 and staged == len(plain)
    print(f"24a engine.bulk: AlexNet's {len(plain)} parameters "
          f"({nbytes / 1e6:.1f} MB) initialised on the card in "
          f"{copies} host-to-device copy carrying {staged} arrays "
          f"({bulk_ms:.1f} ms) against {len(plain)} copies unbulked "
          f"({plain_ms:.1f} ms), bit for bit {same} "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "24a: bulk initialisation differs or is not one copy")
    return {"copies": copies, "bulk_ms": bulk_ms, "plain_ms": plain_ms}


def naive24(mx, card):
    """24a: under MXNET_ENGINE_TYPE=NaiveEngine a failing op on the card
    raises MXNetError naming it, at dispatch (a shape error, no device
    assert), and the next op runs."""
    old = os.environ.get("MXNET_ENGINE_TYPE")
    os.environ["MXNET_ENGINE_TYPE"] = "NaiveEngine"
    try:
        a = mx.nd.ones((2, 3), ctx=mx.gpu(0))
        raised = ""
        try:
            mx.nd.dot(a, mx.nd.ones((7, 2), ctx=mx.gpu(0)))
        except mx.MXNetError as e:
            raised = str(e)
        after = mx.nd.dot(a, mx.nd.ones((3, 2), ctx=mx.gpu(0))).asnumpy()
    finally:
        if old is None:
            os.environ.pop("MXNET_ENGINE_TYPE", None)
        else:
            os.environ["MXNET_ENGINE_TYPE"] = old
    ok = raised.startswith("NaiveEngine: operator 'dot' failed") and \
        bool((after == 3).all())
    print(f"24a NaiveEngine on the card: "
          f"{(raised or 'nothing raised').splitlines()[0][:120]}; "
          f"the next op ran {'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "24a: NaiveEngine did not name the failing op")


def viz24(mx, card):
    """24a: mx.viz.print_summary of AlexNet at 224x224; its total equals
    the parameters' sizes."""
    import contextlib
    import io
    sym = alex_net(mx, 0.0)(mx.sym.Variable("data"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mx.viz.print_summary(sym, shape={"data": (1,) + IMAGE})
    lines = buf.getvalue().splitlines()
    shapes = sym.infer_shape(data=(1,) + IMAGE)[0]
    want = sum(int(np.prod(s)) for n, s in zip(sym.list_arguments(), shapes)
               if n != "data")
    for line in lines:
        print(f"24a viz: {line.rstrip()}")
    ok = lines[-2] == f"Total params: {want}"
    print(f"24a viz: total {want} parameters {'ok' if ok else 'FAIL'} "
          f"[{card}]")
    check(ok, "24a: print_summary's total is not AlexNet's")


def libinfo24(mx, card):
    """24a: libinfo on the card: CUDA, the card's name, the backends, the
    built kernel libraries."""
    f = mx.libinfo.features()
    libs = mx.libinfo.find_lib_path()
    built = [os.path.basename(p) for p in libs]
    ok = f["CUDA"] and f["DEVICE"] == torch.cuda.get_device_name(0) and \
        "gloo" in f["BACKENDS"] and all(
            any(b.startswith(f"lib{k}") or b.startswith(k) for b in built)
            for k in f["KERNELS"])
    print(f"24a libinfo: {f}; libraries {built} {'ok' if ok else 'FAIL'} "
          f"[{card}]")
    check(ok, "24a: libinfo does not report the card and the kernels")


# -- 24b: the ranks --------------------------------------------------------

def rank24(rank, world, coordinator, out_dir):
    """One rank of 24b: joins the group through the port's
    `initialize_distributed`, runs every case, writes rank<rank>.json."""
    import traceback
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if DEV24 == "cuda":
        torch.cuda.set_device(0)
    res = {"rank": rank, "times": {}}
    try:
        import incubator_mxnet_tpu_torch as mx
        t0 = time.perf_counter()
        mx.parallel.initialize_distributed(coordinator, world, rank)
        res["times"]["join"] = time.perf_counter() - t0
        for key, fn in (("verbs", verbs24), ("functional", functional24),
                        ("pipeline", pipeline24), ("tentpole", tentpole24),
                        ("syncbn", syncbn24)):
            t0 = time.perf_counter()
            res[key] = fn(mx, rank)
            res["times"][key] = time.perf_counter() - t0
        res["ok"] = True
    except Exception:
        res["error"] = traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


rank24_target = rank24      # the function a 24b rank runs


def _dev24():
    return torch.device("cuda", 0) if DEV24 == "cuda" else \
        torch.device("cpu")


def verbs24(mx, rank):
    """torch.distributed's verbs on the card's tensors over the gloo
    group (the probe; point-to-point is staged through the host by
    `parallel.verbs`), then `parallel`'s verbs on a dp=4 mesh, exact."""
    import torch.distributed as dist
    dev = _dev24()
    world = dist.get_world_size()
    xs = [torch.arange(8.0, device=dev).reshape(4, 2) + 10 * r
          for r in range(world)]
    x = xs[rank]
    stacked = torch.stack(xs)
    probe = {}
    y = x.clone()
    dist.all_reduce(y)
    probe["all_reduce"] = bool(torch.equal(y, stacked.sum(0)))
    y = x.clone()
    dist.broadcast(y, 1)
    probe["broadcast"] = bool(torch.equal(y, xs[1]))
    y = torch.empty(4 * world, 2, device=dev)
    dist.all_gather_into_tensor(y, x)
    probe["all_gather_into_tensor"] = bool(torch.equal(y, torch.cat(xs)))
    y = torch.empty(1, 2, device=dev)
    dist.reduce_scatter_tensor(y, x.clone())
    probe["reduce_scatter_tensor"] = bool(torch.equal(
        y, stacked.sum(0)[rank:rank + 1]))
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x.clone())
    probe["all_to_all_single"] = bool(torch.equal(
        y, torch.cat([xs[r][rank:rank + 1] for r in range(world)])))
    y = mx.parallel.verbs.send_recv(x, (rank + 1) % world,
                                    (rank - 1) % world)
    probe["send_recv (host-staged)"] = bool(torch.equal(
        y, xs[(rank - 1) % world])) and y.is_cuda == (DEV24 == "cuda")
    par = mx.parallel
    mesh = par.make_mesh({"dp": world}, devices=DEV24)
    exact = {}
    with mesh:
        for op, want in (("sum", stacked.sum(0)), ("mean", stacked.mean(0)),
                         ("max", stacked.max(0).values),
                         ("min", stacked.min(0).values)):
            exact[f"all_reduce {op}"] = bool(torch.equal(
                par.all_reduce(x, "dp", op=op), want))
        exact["all_gather"] = bool(torch.equal(par.all_gather(x, "dp"),
                                               torch.cat(xs)))
        exact["reduce_scatter"] = bool(torch.equal(
            par.reduce_scatter(x, "dp"), stacked.sum(0)[rank:rank + 1]))
        exact["ppermute"] = bool(torch.equal(
            par.ppermute(x, "dp", [(i, (i + 1) % world)
                                   for i in range(world)]),
            xs[(rank - 1) % world]))
        exact["broadcast"] = bool(torch.equal(par.broadcast(x, "dp", 2),
                                              xs[2]))
    return {"probe": probe, "exact": exact,
            "staged": mx.parallel.verbs.staged_count["send_recv"]}


def _mse24(p, batch):
    x, y = batch
    return torch.mean((x @ p["w"] + p["b"] - y) ** 2)


def functional24(mx, rank):
    """data_parallel_step and zero_train_step (Adam) at dp=4 on the card
    against this rank's own computation at the whole batch."""
    from incubator_mxnet_tpu_torch.parallel.data_parallel import (
        sgd_tree_update, value_and_grad)
    from incubator_mxnet_tpu_torch.parallel.zero import (
        zero_train_step, zero_init_state, adam_shard_update)
    par = mx.parallel
    dev = _dev24()
    mesh = par.make_mesh({"dp": 4}, devices=DEV24)
    gen = torch.Generator(device=dev).manual_seed(SEED + 241)
    params = {"w": torch.rand(5, 3, generator=gen, device=dev),
              "b": torch.zeros(3, device=dev)}
    batch = (torch.rand(16, 5, generator=gen, device=dev),
             torch.rand(16, 3, generator=gen, device=dev))
    t0 = time.perf_counter()
    step = par.data_parallel_step(_mse24, sgd_tree_update(momentum=0.0),
                                  mesh)
    opt = {k: torch.zeros_like(v) for k, v in params.items()}
    got, _, _ = step(params, opt, batch, 0.1)
    t_dp = time.perf_counter() - t0
    g = value_and_grad(_mse24)(params, batch)[0]
    dp_worst = max(float(((got[k] - (params[k] - 0.1 * g[k])).abs() / (
        1e-5 * (params[k] - 0.1 * g[k]).abs() + 1e-6)).max()) for k in got)
    n = 4
    state = zero_init_state(params, n, lambda s, d: (
        torch.zeros(s, dtype=d, device=dev), torch.zeros(s, dtype=d,
                                                         device=dev),
        torch.zeros(n, dtype=d, device=dev)))
    zstep = zero_train_step(_mse24, adam_shard_update(lr=0.05), mesh)
    p, s = params, state
    ref = {k: v.clone() for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in ref.items()}
    v = {k: torch.zeros_like(x) for k, x in ref.items()}
    zero_worst, t_zero = 0.0, []
    for t in range(1, 4):
        t0 = time.perf_counter()
        p, s, _ = zstep(p, s, batch)
        t_zero.append(time.perf_counter() - t0)
        gr = value_and_grad(_mse24)(ref, batch)[0]
        for k in ref:
            m[k] = 0.9 * m[k] + 0.1 * gr[k]
            v[k] = 0.999 * v[k] + 0.001 * gr[k] * gr[k]
            ref[k] = ref[k] - 0.05 * (m[k] / (1 - 0.9 ** t)) / (
                torch.sqrt(v[k] / (1 - 0.999 ** t)) + 1e-8)
            zero_worst = max(zero_worst, float(((p[k] - ref[k]).abs() / (
                1e-4 * ref[k].abs() + 1e-5)).max()))
    return {"dp_worst": dp_worst, "zero_worst": zero_worst, "t_dp": t_dp,
            "t_zero": t_zero,
            "zero_local": list(s["w"][0].to_local().shape),
            "zero_global": list(s["w"][0].shape)}


def pipeline24(mx, rank):
    """pipeline_step at pp=4 (each stage adds 1) and pipeline_train_step
    at pp=2 (a dp=2 x pp=2 mesh) against the sequential composition on
    the card."""
    from incubator_mxnet_tpu_torch.parallel.data_parallel import \
        value_and_grad
    par = mx.parallel
    dev = _dev24()
    mesh = par.make_mesh({"pp": 4}, devices=DEV24)
    fwd = par.pipeline_step(lambda p, x: x + p, 8, "pp", mesh=mesh)
    out = fwd(torch.tensor(1.0, device=dev),
              torch.arange(8.0, device=dev).reshape(8, 1, 1))
    add_ok = bool(torch.equal(out.reshape(-1),
                              torch.arange(8.0, device=dev) + 4))
    grid = par.make_mesh({"dp": 2, "pp": 2}, devices=DEV24)
    stage = grid.axis_index("pp")
    gen = torch.Generator(device=dev).manual_seed(SEED + 242)
    W = torch.randn(2, 6, 6, generator=gen, device=dev) * 0.5
    B = torch.zeros(2, 1, 6, device=dev)
    X = torch.randn(4, 8, 6, generator=gen, device=dev)
    T = torch.randn(4, 8, 6, generator=gen, device=dev) * 0.1

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"][0] + p["b"][0])

    def loss_fn(o, t):
        return torch.mean((o - t) ** 2)

    mine = {"w": W[stage:stage + 1], "b": B[stage:stage + 1]}
    with grid:
        got = par.pipeline_step(stage_fn, 4, "pp")(mine, X)
        grads, _ = par.pipeline_train_step(stage_fn, loss_fn, 4,
                                           lambda p, g: g, "pp")(mine, X, T)

    def composed(q):
        a = torch.tanh(X @ q["w"][0] + q["b"][0])
        return loss_fn(torch.tanh(a @ q["w"][1] + q["b"][1]), T)

    want = torch.tanh(torch.tanh(X @ W[0] + B[0]) @ W[1] + B[1])
    g = value_and_grad(lambda q, _: composed(q))({"w": W, "b": B}, None)[0]

    def worst(a, b):
        return float(((a - b).abs() / (1e-4 * b.abs() + 1e-5)).max())
    return {"add_ok": add_ok, "fwd": worst(got, want),
            "grad": max(worst(grads["w"][0], g["w"][stage]),
                        worst(grads["b"][0], g["b"][stage]))}


def tentpole24(mx, rank):
    """The tentpole lane: AlexNet (TPU_PALLAS, Dropout 0) at full width on
    a dp=2 x tp=2 mesh, fc6/fc7 column-parallel over tp (K1 on each
    rank's shards), the batch over dp, Adam with ZeRO over dp, TP24's
    steps; rank 0 then runs one process at the whole batch from the same
    parameters and holds the two (both with cuDNN off: `plain_conv24`).
    Then one more step of both with cuDNN on (`tp24_cudnn_step`)."""
    with plain_conv24():
        out, lanes = tentpole24_lanes(mx, rank)
    tp24_cudnn_step(mx, rank, out, *lanes)
    return out


def tentpole24_lanes(mx, rank):
    """`tentpole24` inside `plain_conv24`.  Every step starts both lanes
    from the reference's state (rank 0 broadcasts its parameters and Adam
    moments; the mesh takes its shards of them), so a step's
    differences are that step's: rank 0 holds the mesh's gradients
    (outside the fc6/fc7 units whose ReLU flipped), loss, parameters and
    moments against its own step outside those units and the elements
    whose two gradients both lie within the gradient tolerance of 0 (Adam
    moves those by ~lr whichever sign rounding gives them), each counted.
    (out, the lanes `tp24_cudnn_step` goes on with)."""
    import torch.distributed as dist
    par = mx.parallel
    P = par.P
    graph = trainer23_graph(mx)
    values, x, y = tp24_values(mx, graph)
    ctx = mx.gpu(0)
    net = block24(mx, graph, values, ctx)
    ref = block24(mx, graph, values, ctx)
    mesh = par.make_mesh({"dp": 2, "tp": 2}, devices=DEV24)
    rules = par.ShardingRules([(r"dense[01]_(weight|bias)", P("tp"))])
    par.shard_block(net, mesh, rules)
    data = par.put(mx.nd.array(x, ctx=ctx), mesh, P("dp"))
    label = par.put(mx.nd.array(y, ctx=ctx), mesh, P("dp"))
    trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": TP24["lr"]}, zero=mesh)
    ref_trainer = mx.gluon.Trainer(ref.collect_params(), "adam",
                                   {"learning_rate": TP24["lr"]})
    params, rparams = net.collect_params(), ref.collect_params()
    names = list(params)
    shapes = []
    out = {"losses": [], "ref_losses": [], "step_s": [], "launches": 0,
           "grad": (0.0, "none"), "worst": (0.0, "none"), "flips": [],
           "excused": [], "beyond": {},
           "elements": sum(p.data().data.numel() for p in params.values())}
    moments = None
    for step in range(TP24["steps"]):
        if step:
            moments = teach24(trainer, params, ref_trainer, rparams,
                              moments)
        if DEV24 == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, launches = mesh_step24(mx, net, trainer, data, label,
                                            shapes)
        out["losses"].append(loss)
        out["step_s"].append(time.perf_counter() - t0)
        out["launches"] += launches
        states = trainer._updaters[0].states
        whole = {n: p.data().data.full_tensor() for n, p in params.items()}
        whole_states = {names[i]: [s.data.full_tensor() for s in states[i]]
                        for i in states}
        if rank == 0:
            tp24_ref_step(mx, graph, ref, ref_trainer, x, y, grads, whole,
                          whole_states, out)
        dist.barrier()
    fc6 = params[f"{ALEX_PREFIX}dense0_weight"].data().data
    states = trainer._updaters[0].states
    out.update(
        shapes=sorted(set(shapes)), fc6_local=list(fc6.to_local().shape),
        fc6_placements=str(tuple(fc6.placements)),
        halved=all(s.data.to_local().numel() * 2 == s.data.numel()
                   for i in states for s in states[i]
                   if s.shape[0] % 2 == 0))
    if rank == 0:
        out["loss_err"] = max(abs(a - b) / abs(b) for a, b in
                              zip(out["losses"], out["ref_losses"]))
        (out["grad1"], out["grad1_at"]), (out["worst"], out["worst_at"]) = \
            out.pop("grad"), out.pop("worst")
    return out, (graph, net, ref, trainer, ref_trainer, data, label, x, y,
                 moments)


def mesh_step24(mx, net, trainer, data, label, shapes):
    """One step of the mesh lane: (mean loss, each parameter's whole
    gradient, K1's launches), the (x, w) shapes of K1's launches appended
    to `shapes`."""
    from incubator_mxnet_tpu_torch.subgraph import fused_ops
    real = fused_ops._launch

    def seen(a, w, b, route):
        shapes.append((tuple(a.shape), tuple(w.shape)))
        return real(a, w, b, route)

    fused_ops._launch = seen
    before = fused_ops.fc_relu.launches
    try:
        with mx.autograd.record():
            loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(net(data), label)
        loss.backward()
        # a replicated DTensor's whole tensor is its local one: copy it,
        # the next backward writes the buffer
        grads = {n: p.grad().data.full_tensor().clone()
                 for n, p in net.collect_params().items()}
        trainer.step(TP24["batch"])
        return (float(loss.mean().asnumpy()), grads,
                fused_ops.fc_relu.launches - before)
    finally:
        fused_ops._launch = real


def tp24_cudnn_step(mx, rank, out, graph, net, ref, trainer, ref_trainer,
                    data, label, x, y, moments):
    """One more mesh step with cuDNN on (the route a user's convolutions
    take) from the reference's state, K1's launches and shapes counted on
    every rank; rank 0 holds its loss and gradients against one process
    with cuDNN on at the whole batch, each gradient within CUSTOM24_TOL
    plus CUDNN24_ENVELOPE times cuDNN's own error in that array (one
    process, the dp halves against the whole batch), outside the fc6/fc7
    units whose ReLU flipped (counted)."""
    import torch.distributed as dist
    params, rparams = net.collect_params(), ref.collect_params()
    teach24(trainer, params, ref_trainer, rparams, moments)
    check(torch.backends.cudnn.enabled, "24b: cuDNN is off for its step")
    shapes = []
    got_loss, grads, out["cudnn_launches"] = mesh_step24(
        mx, net, trainer, data, label, shapes)
    out["cudnn_shapes"] = sorted(set(shapes))
    if rank == 0:
        cur = {n: p.data().data for n, p in rparams.items()}
        mask = tp24_flips(mx, graph, cur, x)
        ctx = mx.gpu(0)

        def ref_grads(xb, yb):
            with mx.autograd.record():
                rloss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
                    ref(mx.nd.array(xb, ctx=ctx)), mx.nd.array(yb, ctx=ctx))
            rloss.backward()
            return ({n: p.grad().data.clone() for n, p in rparams.items()},
                    float(rloss.mean().asnumpy()))

        half = x.shape[0] // 2
        first, _ = ref_grads(x[:half], y[:half])
        second, _ = ref_grads(x[half:], y[half:])
        whole, want_loss = ref_grads(x, y)
        rtol, atol = CUSTOM24_TOL
        worst, own = (0.0, "none"), (0.0, "none")
        with torch.no_grad():
            for n, g in whole.items():
                keep = ~mask.get(n, torch.zeros_like(g, dtype=torch.bool))
                top = g.abs().max()
                err = float((first[n] + second[n] - g).abs()[keep].max())
                v = float(((grads[n] - g).abs() / (
                    CUDNN24_ENVELOPE * err + rtol * g.abs() + atol * top
                    + 1e-30))[keep].max())
                worst = max(worst, (v, n))
                own = max(own, (err / float(top + 1e-30), n))
        out.update(cudnn_loss=(got_loss, want_loss),
                   cudnn_loss_err=abs(got_loss - want_loss) / abs(want_loss),
                   cudnn_grad=worst[0], cudnn_grad_at=worst[1],
                   cudnn_own=own[0], cudnn_own_at=own[1],
                   cudnn_flips=int(sum(int(m.sum()) for n, m in mask.items()
                                       if n.endswith("_bias"))))
    dist.barrier()


def teach24(trainer, params, ref_trainer, rparams, moments):
    """Both lanes from the reference's state: rank 0's parameters and Adam
    moments broadcast to every rank (into `moments`, buffers kept across
    steps on the other ranks; returned), then each mesh parameter and
    moment takes its shards of them."""
    import torch.distributed as dist
    from incubator_mxnet_tpu_torch.parallel.tensor_parallel import \
        local_chunk
    rank = dist.get_rank()
    names = list(rparams)
    rstates = ref_trainer._updaters[0].states
    if moments is None:
        moments = {n: [rstates[i][k].data if rank == 0 else
                       torch.empty_like(rparams[n].data().data)
                       for k in range(2)] for i, n in enumerate(names)}
    mstates = trainer._updaters[0].states
    with torch.no_grad():
        for i, n in enumerate(names):
            whole = [rparams[n].data().data.detach()] + moments[n]
            for t in whole:
                dist.broadcast(t, 0)
            targets = [params[n].data().data] + [s.data
                                                 for s in mstates[i]]
            for t, src in zip(targets, whole):
                t.to_local().copy_(local_chunk(src, t.device_mesh,
                                               t.placements))
    return moments


def tp24_ref_step(mx, graph, ref, ref_trainer, x, y, grads, whole,
                  whole_states, out):
    """Rank 0: the reference's step from the state both lanes started
    from; the mesh's gradients, loss, parameters and moments held against
    it (the worst of each kept in `out`)."""
    ctx = mx.gpu(0)
    params = ref.collect_params()
    names = list(params)
    cur = {n: p.data().data for n, p in params.items()}
    mask = tp24_flips(mx, graph, cur, x)
    out["flips"].append(int(sum(int(m.sum()) for n, m in mask.items()
                                if n.endswith("_bias"))))
    with mx.autograd.record():
        loss = mx.gluon.loss.SoftmaxCrossEntropyLoss()(
            ref(mx.nd.array(x, ctx=ctx)), mx.nd.array(y, ctx=ctx))
    loss.backward()
    out["ref_losses"].append(float(loss.mean().asnumpy()))
    gtol, (rtol, atol) = CUSTOM24_TOL, TP24_TOL
    excused = 0
    with torch.no_grad():
        keep, gkeep = {}, {}
        for n, p in params.items():
            g = p.grad().data
            flip = mask.get(n, torch.zeros_like(g, dtype=torch.bool))
            gkeep[n] = ~flip
            tol0 = gtol[0] * g.abs() + gtol[1] * g.abs().max()
            near0 = (g.abs() <= tol0) & (grads[n].abs() <= tol0) & \
                (grads[n] != g)
            keep[n] = ~(flip | near0)
            excused += int((near0 & ~flip).sum())
            v = float(((grads[n] - g).abs() / (
                gtol[0] * g.abs() + gtol[1] * g.abs().max() + 1e-30))[
                gkeep[n]].max())
            out["grad"] = max(out["grad"], (v, f"{n} step {len(out['flips'])}"))
        ref_trainer.step(TP24["batch"])
        states = ref_trainer._updaters[0].states
        for n, p in params.items():
            i = names.index(n)
            for label_, got, want in (("weight", whole[n], p.data().data),
                                      ("mean", whole_states[n][0],
                                       states[i][0].data),
                                      ("var", whole_states[n][1],
                                       states[i][1].data)):
                ratio = ((got - want).abs() / (
                    rtol * want.abs() + atol * want.abs().max()
                    + 1e-30))[keep[n]]
                v = float(ratio.max()) if keep[n].any() else 0.0
                if int((ratio > 1).sum()):
                    key = f"{n} {label_}"
                    out["beyond"][key] = out["beyond"].get(key, 0) + \
                        int((ratio > 1).sum())
                out["worst"] = max(out["worst"],
                                   (v, f"{n} {label_} step "
                                    f"{len(out['flips'])}"))
    out["excused"].append(excused)


def tp24_flips(mx, graph, params, x):
    """{name: mask} of fc6's and fc7's units whose ReLU sign differs
    between K1 on the shards (the dp half of the rows, the tp half of the
    columns) and K1 at the whole batch and width, at `params`."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    internals = graph.get_internals()
    names = internals.list_outputs()
    flat = [n for n in names if "flatten" in n and n.endswith("_output")]
    check(len(flat) == 1, f"24b: {flat} flatten outputs in AlexNet")
    feats = block24(mx, internals[names.index(flat[0])], {
        k: v for k, v in params.items()
        if k in internals[names.index(flat[0])].list_arguments()},
        mx.gpu(0))(mx.nd.array(x, ctx=mx.gpu(0))).data
    mask, h = {}, feats
    half, cols = x.shape[0] // 2, None
    for layer in ("dense0", "dense1"):
        w = params[f"{ALEX_PREFIX}{layer}_weight"]
        b = params[f"{ALEX_PREFIX}{layer}_bias"]
        whole = fc_relu(h, w, b)
        n = w.shape[0] // 2
        shard = torch.cat([torch.cat([fc_relu(h[r * half:(r + 1) * half],
                                              w[c * n:(c + 1) * n],
                                              b[c * n:(c + 1) * n])
                                      for c in range(2)], 1)
                           for r in range(2)], 0)
        units = ((whole > 0) != (shard > 0)).any(0)
        mask[f"{ALEX_PREFIX}{layer}_weight"] = units[:, None].expand(
            w.shape)
        mask[f"{ALEX_PREFIX}{layer}_bias"] = units
        h = whole
    return mask


def bn24_net(mx, ctx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="bn24_")
    with net.name_scope():
        net.add(nn.Dense(BN24["hidden"], prefix="d0_"),
                nn.SyncBatchNorm(prefix="sbn_"), nn.Activation("relu"),
                nn.Dense(4, prefix="d1_"))
    net.initialize(ctx=ctx)
    net(mx.nd.zeros((2, BN24["features"]), ctx=ctx))
    gen = torch.Generator(device=_dev24()).manual_seed(SEED + 243)
    for p in net.collect_params().values():
        if not p.name.endswith(("running_mean", "running_var")):
            p.set_data(torch.randn(p.shape, generator=gen,
                                   device=_dev24()) * 0.3)
    return net


def syncbn24(mx, rank):
    """SyncBatchNorm at dp=4 on the card (each rank a quarter of the
    batch under the bound mesh, gradients summed over dp) against rank
    0's whole batch alone: parameters and moving statistics."""
    import torch.distributed as dist
    par = mx.parallel
    dev = _dev24()
    mesh = par.make_mesh({"dp": 4}, devices=DEV24)
    gen = torch.Generator(device=dev).manual_seed(SEED + 244)
    x = torch.randn(BN24["batch"], BN24["features"], generator=gen,
                    device=dev)
    y = torch.randint(0, 4, (BN24["batch"],), generator=gen,
                      device=dev).float()
    q = BN24["batch"] // 4
    ctx = mx.gpu(0)
    loss_fn = mx.gluon.loss.SoftmaxCrossEntropyLoss()

    def train(net, xs, ys, synced):
        trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": BN24["lr"]})
        for _ in range(BN24["steps"]):
            if synced:
                with mesh, mx.autograd.record():
                    loss = loss_fn(net(xs), ys)
            else:
                with mx.autograd.record():
                    loss = loss_fn(net(xs), ys)
            loss.backward()
            if synced:
                for p in net.collect_params().values():
                    if p.grad_req != "null":
                        p.grad()._set_data(par.all_reduce(
                            p.grad().data, "dp", mesh=mesh))
            trainer.step(BN24["batch"])
        return {n: p.data().data for n, p in net.collect_params().items()}

    got = train(bn24_net(mx, ctx),
                mx.nd.array(x[rank * q:(rank + 1) * q], ctx=ctx),
                mx.nd.array(y[rank * q:(rank + 1) * q], ctx=ctx), True)
    out = {}
    if rank == 0:
        want = train(bn24_net(mx, ctx), mx.nd.array(x, ctx=ctx),
                     mx.nd.array(y, ctx=ctx), False)
        rtol, atol = BN24_TOL
        worst, at = 0.0, "none"
        for n, w in want.items():
            v = float(((got[n] - w).abs() / (rtol * w.abs() + atol)).max())
            if v > worst:
                worst, at = v, n
        out = {"worst": worst, "worst_at": at}
    dist.barrier()
    return out


def mesh24_start(workdir):
    """Spawn 24b's WORLD24 ranks (they join and run while the parent goes
    on): (processes, their result directory, the start time)."""
    ctx = torch.multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="mesh24_", dir=workdir)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    gc.collect()
    if DEV24 == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=rank24_target, args=(r, WORLD24,
                                              f"127.0.0.1:{port}", out_dir),
                         name=f"mesh24-rank-{r}") for r in range(WORLD24)]
    for p in procs:
        p.start()
    return procs, out_dir, t0


def mesh24(mx, card, started):
    """24b: the group `mesh24_start` spawned; every case's gates read
    from the ranks' results."""
    procs, out_dir, t0 = started
    deadline = time.monotonic() + TP24_DEADLINE_S
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        hung = [p.name for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    wall = time.perf_counter() - t0
    check(not hung, f"24b: ranks past {TP24_DEADLINE_S:.0f} s: {hung}")
    res = []
    for r in range(WORLD24):
        path = os.path.join(out_dir, f"rank{r}.json")
        check(os.path.exists(path), f"24b: rank {r} wrote no result "
              f"(exit {procs[r].exitcode})")
        with open(path) as f:
            res.append(json.load(f))
    for r in res:
        check(r.get("ok"), f"24b: rank {r['rank']} failed:\n"
              f"{r.get('error')}")
    shutil.rmtree(out_dir, ignore_errors=True)
    r0 = res[0]
    joins = [r["times"]["join"] for r in res]
    print(f"24b group: {WORLD24} ranks (gloo, the card shared) through "
          f"parallel.initialize_distributed in {wall:.1f} s with process "
          f"starts; joined in {min(joins):.2f}-{max(joins):.2f} s; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in r0["times"].items())
          + f" (rank 0) [{card}]")
    probe_ok = all(all(r["verbs"]["probe"].values()) for r in res)
    exact_ok = all(all(r["verbs"]["exact"].values()) for r in res)
    print(f"24b verbs: torch.distributed on the card's tensors over gloo, "
          f"exact on every rank: "
          + ", ".join(f"{k} {v}" for k, v in r0["verbs"]["probe"].items())
          + f" ({r0['verbs']['staged']} exchanges through the host); "
          f"parallel's verbs: "
          + ", ".join(f"{k} {v}" for k, v in r0["verbs"]["exact"].items())
          + f" {'ok' if probe_ok and exact_ok else 'FAIL'} [{card}]")
    check(probe_ok and exact_ok, "24b: a collective verb is not exact on "
          "the card")
    fn = [r["functional"] for r in res]
    fn_ok = all(f["dp_worst"] <= 1 and f["zero_worst"] <= 1 and
                f["zero_local"] == [4] and f["zero_global"] == [16]
                for f in fn)
    print(f"24b functional: data_parallel_step at dp=4 at "
          f"{max(f['dp_worst'] for f in fn):.3f} of rtol 1e-5 + 1e-6 "
          f"against one rank's step; zero_train_step (Adam) 3 steps at "
          f"{max(f['zero_worst'] for f in fn):.3f} of rtol 1e-4 + 1e-5 "
          f"against replicated Adam, state {fn[0]['zero_global']} global, "
          f"{fn[0]['zero_local']} a rank; rank 0's data_parallel_step "
          f"{fn[0]['t_dp']:.2f} s, zero steps "
          + ", ".join(f"{v:.2f}" for v in fn[0]["t_zero"])
          + f" s {'ok' if fn_ok else 'FAIL'} [{card}]")
    check(fn_ok, "24b: a functional SPMD step disagrees with one rank")
    pp = [r["pipeline"] for r in res]
    pp_ok = all(p["add_ok"] and p["fwd"] <= 1 and p["grad"] <= 1
                for p in pp)
    print(f"24b pipeline: pipeline_step at pp=4 exact {all(p['add_ok'] for p in pp)}; "
          f"pipeline_train_step at pp=2: forward at "
          f"{max(p['fwd'] for p in pp):.3f}, gradients at "
          f"{max(p['grad'] for p in pp):.3f} of rtol 1e-4 + 1e-5 against "
          f"the sequential composition {'ok' if pp_ok else 'FAIL'} "
          f"[{card}]")
    check(pp_ok, "24b: the pipeline disagrees with the composition")
    tp = [r["tentpole"] for r in res]
    want_shapes = sorted({((m, k), (n, k)) for m, k, n in TP24_K1})
    got_shapes = [sorted(tuple(map(tuple, s)) for s in t["shapes"])
                  for t in tp]
    cudnn_shapes = [sorted(tuple(map(tuple, s)) for s in t["cudnn_shapes"])
                    for t in tp]
    t0_ = tp[0]
    excuse_max = int(TP24_EXCUSE_MAX * t0_["elements"])
    tp_ok = all(t["launches"] == 2 * TP24["steps"] for t in tp) and \
        all(g == want_shapes for g in got_shapes) and \
        all(t["fc6_local"] == [TP24_K1[0][2], TP24_K1[0][1]] and
            t["halved"] for t in tp) and \
        t0_["loss_err"] <= TP24_LOSS_RTOL and t0_["grad1"] <= 1 and \
        t0_["worst"] <= 1 and max(t0_["excused"]) <= excuse_max
    cudnn_ok = all(t["cudnn_launches"] == 2 for t in tp) and \
        all(g == want_shapes for g in cudnn_shapes) and \
        t0_["cudnn_loss_err"] <= TP24_LOSS_RTOL and t0_["cudnn_grad"] <= 1
    step_ms = statistics.median(s * 1e3 for s in t0_["step_s"][1:])
    print(f"24b tentpole: AlexNet (TPU_PALLAS, Dropout 0) fp32 at dp=2 x "
          f"tp=2, global batch {TP24['batch']}, Adam lr {TP24['lr']:g} with "
          f"zero=mesh, {TP24['steps']} steps: losses "
          + " ".join(f"{v:.6f}" for v in t0_["losses"])
          + f" vs one process at the whole batch from the same state "
          + " ".join(f"{v:.6f}" for v in t0_["ref_losses"])
          + f" (max rel err {t0_['loss_err']:.2e}, rtol {TP24_LOSS_RTOL:g});"
          f" each step from the reference's state: gradients at "
          f"{t0_['grad1']:.3f} of rtol {CUSTOM24_TOL[0]:g} + "
          f"{CUSTOM24_TOL[1]:g}*max (worst {t0_['grad1_at']}); parameters "
          f"and Adam state at {t0_['worst']:.3f} of rtol {TP24_TOL[0]:g} + "
          f"{TP24_TOL[1]:g}*max (worst {t0_['worst_at']}; elements beyond: "
          f"{t0_['beyond'] or 'none'}) outside {t0_['flips']} fc6/fc7 units "
          f"flipped between the shards' K1 and the whole batch's and "
          f"{t0_['excused']} elements (at most {excuse_max}, "
          f"{TP24_EXCUSE_MAX:.1%} of {t0_['elements']}) whose two gradients "
          f"differ and both lie within their tolerance of 0; fc6's shard "
          f"{t0_['fc6_local']} {t0_['fc6_placements']}, Adam state halved "
          f"over dp on every rank {all(t['halved'] for t in tp)}; K1 "
          f"launches per rank {[t['launches'] for t in tp]} at "
          f"{got_shapes[0]}; step median {step_ms:.1f} ms "
          f"{'ok' if tp_ok else 'FAIL'} [{card}]")
    check(tp_ok, "24b: the tentpole lane disagrees with one process or "
          "K1 did not run on every rank's shards")
    print(f"24b tentpole, cuDNN on: one more mesh step from the reference's "
          f"state vs one process with cuDNN on: loss {t0_['cudnn_loss'][0]:.6f}"
          f" vs {t0_['cudnn_loss'][1]:.6f} (rel err "
          f"{t0_['cudnn_loss_err']:.2e}, rtol {TP24_LOSS_RTOL:g}); gradients "
          f"at {t0_['cudnn_grad']:.3f} of rtol {CUSTOM24_TOL[0]:g} + "
          f"{CUSTOM24_TOL[1]:g}*max + {CUDNN24_ENVELOPE:g}x cuDNN's own "
          f"error (worst {t0_['cudnn_grad_at']}; cuDNN's own, the batch "
          f"halves vs the whole in one process: up to "
          f"{t0_['cudnn_own']:.2e} of the largest, {t0_['cudnn_own_at']}) "
          f"outside "
          f"{t0_['cudnn_flips']} flipped fc6/fc7 units; K1 launches per rank "
          f"{[t['cudnn_launches'] for t in tp]} at {cudnn_shapes[0]} "
          f"{'ok' if cudnn_ok else 'FAIL'} [{card}]")
    check(cudnn_ok, "24b: the mesh step with cuDNN on disagrees with one "
          "process or K1 did not run on every rank's shards")
    bn = res[0]["syncbn"]
    bn_ok = bn["worst"] <= 1
    print(f"24b SyncBatchNorm at dp=4: {BN24['steps']} SGD steps, each rank "
          f"{BN24['batch'] // 4} of {BN24['batch']} rows, vs one rank at "
          f"the whole batch: parameters and moving statistics at "
          f"{bn['worst']:.3f} of rtol {BN24_TOL[0]:g}, atol "
          f"{BN24_TOL[1]:g} (worst {bn['worst_at']}) "
          f"{'ok' if bn_ok else 'FAIL'} [{card}]")
    check(bn_ok, "24b: SyncBatchNorm across ranks disagrees with one rank")
    return {"launches": sum(t["launches"] + t["cudnn_launches"]
                            for t in tp), "wall_s": wall,
            "step_ms": step_ms, "worst": t0_["worst"],
            "grad": t0_["grad1"], "flips": sum(t0_["flips"]),
            "excused": sum(t0_["excused"]),
            "per_rank": [t["launches"] + t["cudnn_launches"] for t in tp]}


def module24(mx, card):
    """24c: train_mnist's mlp (TPU_PALLAS) on [gpu(0), gpu(0)] with
    mesh='dp=2': PARITY_STEPS steps against one context (14b's gates),
    then Module.fit(mesh='dp=2') for 2 epochs (phase 6's accuracy gate);
    K1 2 a forward in each context."""
    from incubator_mxnet_tpu_torch.subgraph.fused_ops import fc_relu
    old = os.environ.get("MXNET_SUBGRAPH_BACKEND")
    os.environ["MXNET_SUBGRAPH_BACKEND"] = "TPU_PALLAS"
    try:
        sym = mlp_symbol(mx)
        train, val = mnist_iters(mx)
        batches = [next(train) for _ in range(PARITY_STEPS)]
        init = dp_init(mx, sym)
        _, ref_loss, ref_p, ref_m, _ = dp_steps(mx, sym, [mx.gpu(0)],
                                                batches, init, "local")
        fc_relu.launches = 0
        mod, loss, p, m, _ = dp_steps(mx, sym, [mx.gpu(0), mx.gpu(0)],
                                      batches, init, "device",
                                      mesh="dp=2")
        parity = fc_relu.launches
        loss_err = max(abs(g - c) / abs(c) for g, c in zip(loss, ref_loss))
        pw, pn = held_worst(p, ref_p, DP_TOL)
        mw, mn = held_worst(m, ref_m, DP_TOL)
        train.reset()
        fit = mx.mod.Module(sym, context=[mx.gpu(0), mx.gpu(0)])
        mx.random.seed(SEED)
        fc_relu.launches = 0
        t0 = time.perf_counter()
        fit.fit(train, eval_data=val, kvstore="device", optimizer="sgd",
                optimizer_params={"learning_rate": TRAIN_LR,
                                  "momentum": TRAIN_MOMENTUM},
                initializer=mx.initializer.Xavier(), num_epoch=2,
                mesh="dp=2")
        wall = time.perf_counter() - t0
        launches = fc_relu.launches
        acc = fit.score(val, "acc")[0][1]
    finally:
        if old is None:
            os.environ.pop("MXNET_SUBGRAPH_BACKEND", None)
        else:
            os.environ["MXNET_SUBGRAPH_BACKEND"] = old
    steps = 2 * -(-TRAIN_SPLIT // TRAIN_BATCH)
    evals = 2 * -(-(TRAIN_IMAGES - TRAIN_SPLIT) // TRAIN_BATCH)
    ok = mod._dp_size == 2 and fit._dp_size == 2 and \
        loss_err <= DP_TOL[0] and pw <= 1 and mw <= 1 and \
        parity == 4 * PARITY_STEPS and acc > 0.95 and \
        launches == 4 * (steps + evals)
    print(f"24c Module mesh='dp=2' on [gpu(0), gpu(0)]: {PARITY_STEPS} steps "
          f"vs one context: max rel loss err {loss_err:.2e} (rtol "
          f"{DP_TOL[0]:g}); parameters at {pw:.3f} (worst {pn}), momenta at "
          f"{mw:.3f} (worst {mn}) of the tolerance; K1 {parity} (4 a step);"
          f" fit(mesh='dp=2') 2 epochs in {wall:.2f} s, dp_size "
          f"{fit._dp_size}, validation accuracy {acc:.4f} (> 0.95), K1 "
          f"{launches} = 4 x ({steps} train + {evals} eval forwards) "
          f"{'ok' if ok else 'FAIL'} [{card}]")
    check(ok, "24c: Module over a dp mesh disagrees with one context")
    return parity + launches


def parallel_phase(card, workdir):
    """Phase 24: the small public modules in process (24a), the mesh of
    ranks (24b, spawned first), Module over a dp mesh (24c); K1's
    launches on each path."""
    import incubator_mxnet_tpu_torch as mx
    out, times = {}, {}
    # 24b's ranks start first and run while 24a and 24c run here: their
    # process starts (~15 s) overlap the in-process parts
    started = mesh24_start(workdir)
    for key, fn in (("24a", lambda: {
                        "custom": custom24(mx, card),
                        "bulk": bulk24(mx, card),
                        "naive": naive24(mx, card), "viz": viz24(mx, card),
                        "libinfo": libinfo24(mx, card)}),
                    ("24c", lambda: module24(mx, card)),
                    ("24b", lambda: mesh24(mx, card, started))):
        t0 = started[2] if key == "24b" else time.perf_counter()
        out[key] = fn()
        times[key] = time.perf_counter() - t0
        print(f"phase {key}: {times[key]:.1f} s"
              + (" (from its ranks' spawn, beside 24a and 24c)"
                 if key == "24b" else ""))
    out["times"] = times
    out["k1"] = {"custom_op_head": out["24a"]["custom"],
                 "tensor_parallel": out["24b"]["launches"],
                 "module_mesh": out["24c"]}
    return out


def bytecode_cache(root):
    """Cache the bytecode of this process's later imports and of every
    Python process it starts under <root>/build/pycache: the card's
    machine sets PYTHONDONTWRITEBYTECODE over a site-packages without
    bytecode, so each process compiled torch's sources anew at import.
    Start one process that imports what the children import (torch, its
    DTensor and dynamo, numpy, the port, this script), compiling it while
    the kernels build; the caller waits for it."""
    path = os.path.join(root, "build", "pycache")
    os.makedirs(path, exist_ok=True)
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = path
    sys.dont_write_bytecode = False
    sys.pycache_prefix = path
    return subprocess.Popen(
        [sys.executable, "-c",
         "import numpy, torch, torch._dynamo, torch.distributed.tensor, "
         "incubator_mxnet_tpu_torch, chip_smoke"], cwd=root,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def main():
    if sys.argv[1:]:
        print(f"usage: python3 chip_smoke.py (takes no arguments; got "
              f"{' '.join(sys.argv[1:])})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from incubator_mxnet_tpu_torch.kernels import _build

    card = card_line()
    print(f"device: {card}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for matmul and cuDNN (fp32 comparisons are fp32)")

    t0 = time.perf_counter()
    warm = bytecode_cache(os.path.dirname(os.path.abspath(__file__)))
    _build.build_all()
    print(f"build: {', '.join(_build.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s")
    try:
        warm.wait(300)
    finally:
        if warm.poll() is None:
            warm.kill()
            warm.wait()
    print(f"build: Python bytecode cached in {sys.pycache_prefix} "
          f"(exit {warm.returncode}) {time.perf_counter() - t0:.1f} s after "
          f"the build began")
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            entry = re.search(r"entry function '\w*?_cu_[0-9a-f]+\d+(\w+)'",
                              line)
            if entry:
                print(f"build: {name}: {entry.group(1)[:60]}")
            elif "registers" in line or "spill" in line or \
                    "wgmma" in line.lower():
                print(f"build: {name}: {line.strip()}")
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill", log)]
        print(f"build: {name}: {log.count('Compiling entry')} kernels, "
              f"{sum(spills)} spill bytes in all")

    k1 = kernel_phase(card)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    t0 = time.perf_counter()
    attn = attn_kernel_phase(card, flush)
    print(f"phase 3b: {time.perf_counter() - t0:.1f} s")
    launches = serve_phase(card, str(_build.BUILD_DIR.parent))
    t0 = time.perf_counter()
    k2_launches, k3_launches = attention_path_phase(card, flush)
    print(f"phase 5: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_launches, train = train_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 6: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    resnet = resnet_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 7: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gluon = gluon_phase(card, resnet["bf16"]["images_s"])
    print(f"phase 8: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm = lm_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lmt = lm_train_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lstm = lstm_phase(card)
    print(f"phase 11: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    imagenet = imagenet_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 12: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ssd = ssd_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    kvp = kv_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 14: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    reg = registry_phase(card)
    print(f"phase 15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    api = api_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 16: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    zoo = zoo_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    loaders = loader_phase(card, str(_build.BUILD_DIR.parent), {
        "iter_rate": imagenet["iter_f32"],
        "resident": zoo["17b"]["images_s"],
        "lm_tokens_s": lmt["lane"]["tokens_s"]})
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    s17 = slice17_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 19: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    f20 = fleet_phase(card, str(_build.BUILD_DIR.parent))
    t21 = f20["times"]["21acd"] + f20["20c"]["21b"]["ms"] / 1e3
    print(f"phase 20: {time.perf_counter() - t0 - t21:.1f} s")
    print(f"phase 21: {t21:.1f} s (21a, 21c, 21d, and 21b's scrape inside "
          f"20c)")
    t0 = time.perf_counter()
    g22 = guardian_phase(card, str(_build.BUILD_DIR.parent))
    for k, v in g22["times"].items():
        print(f"phase {k}: {v:.1f} s")
    print(f"phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    e23 = elastic_phase(card, str(_build.BUILD_DIR.parent),
                        zoo["17b"]["images_s"])
    print(f"phase 23: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    p24 = parallel_phase(card, str(_build.BUILD_DIR.parent))
    print(f"phase 24: {time.perf_counter() - t0:.1f} s")

    print(f"card: {card}")
    bf16, fp32, prof = resnet["bf16"], resnet["fp32"], resnet["profile"]
    print(f"resnet50 summary: bf16 batch {RESNET_BATCH} "
          f"{bf16['images_s']:.1f} images/s, step {bf16['step_ms']:.3f} ms, "
          f"mfu {bf16['mfu']:.4f}, peak {bf16['peak_gib']:.2f} GiB; fp32 "
          f"batch {RESNET_FP32[0]} {fp32['images_s']:.1f} images/s, mfu "
          f"{fp32['mfu']:.4f}; profiled bf16 step busy {prof['busy']:.3f}, "
          f"host {prof['host_ms']:.1f} ms; parity {resnet['parity_s']:.1f} s "
          f"[{card}]")
    for key, what in (("bench", "Estimator.fit resnet50_v1"),
                      ("baseline3", "hybridized resnet50_v2 plain loop"),
                      ("eager_v2", "un-hybridized resnet50_v2 plain loop")):
        g = gluon[key]
        print(f"gluon summary: {what} bf16 batch {RESNET_BATCH} "
              f"{g['images_s']:.1f} images/s, step {g['step_ms']:.3f} ms, "
              f"mfu {g['mfu']:.4f}, peak {g['peak_gib']:.2f} GiB "
              f"({g['steady_gib']:.2f} timed), "
              f"gluon_vs_module {g['gluon_vs_module']:.3f}; profiled step "
              f"{g['profile']['kernels']} kernels, busy "
              f"{g['profile']['busy']:.3f}, host "
              f"{g['profile']['host_ms']:.1f} ms [{card}]")
    g = gluon["bench_eager"]
    print(f"gluon summary: Estimator.fit resnet50_v1 eager loop bf16 batch "
          f"{RESNET_BATCH} {g['images_s']:.1f} images/s, step "
          f"{g['step_ms']:.3f} ms, peak {g['peak_gib']:.2f} GiB "
          f"({g['steady_gib']:.2f} timed) [{card}]")
    print(f"gluon summary: parity {gluon['parity_s']:.1f} s [{card}]")
    par = lm["parity"]
    for dt in ("fp32", "bf16"):
        g, prof = lm[dt], lm["profile" if dt == "fp32" else "profile_bf16"]
        print(f"lm summary: {dt} GPT-2-small widths, {LM_SLOTS} slots: "
              f"continuous {g['tokens_s']:.1f} tokens/s, static "
              f"{g['static_tokens_s']:.1f} (ratio {g['ratio']:.3f}), "
              f"{g['ticks']} ticks, tick median {g['tick_ms']:.3f} ms p99 "
              f"{g['tick_p99_ms']:.3f} ms, step {g['step_ms']:.3f} ms, "
              f"prefill " + "/".join(f"{ms:.2f}" for ms in
                                     g["prefill_ms"].values())
              + f" ms (buckets {'/'.join(map(str, LM_BUCKETS))}), peak "
              f"{g['peak_gib']:.2f} GiB; profiled tick {prof['kernels']} "
              f"kernels, device {prof['device_ms']:.3f} ms, busy "
              f"{prof['busy']:.3f}, host {prof['host_ms']:.2f} ms, step "
              f"bytes bound {prof['bound_ms']:.3f} ms [{card}]")
    print(f"lm summary: parity worst {par['worst']:.3f} of the tolerance, "
          f"{par['ties']} near ties, bf16 relative L2 {par['bf16_l2']:.5f} "
          f"[{card}]")
    lane, ck, prof = lmt["lane"], lmt["ckpt"], lmt["profile"]
    parts = lmt["parts"]
    print(f"lm train summary: fp32 GPT-2-small widths, batch "
          f"{LM_TRAIN_LANE[0]} x T {LM_TRAIN_LANE[1]}: "
          f"{lane['tokens_s']:.1f} tokens/s, step {lane['step_ms']:.3f} ms, "
          f"mfu {lane['mfu']:.4f}, peak {lane['peak_gib']:.2f} GiB; "
          f"checkpointed every {LM_CKPT_PERIOD}: {ck['tokens_s']:.1f} "
          f"tokens/s ({ck['slowdown']:.3f}x step), snapshot sync "
          f"{ck['sync_ms']:.2f} ms, write {ck['write_s']:.2f} s for "
          f"{ck['write_bytes'] / 1e9:.3f} GB; profiled step busy "
          f"{prof['busy']:.3f}, host {prof['host_ms']:.1f} ms; attention "
          f"{parts['attention_all']:.2f} ms, head+SoftmaxOutput "
          f"{parts['head']:.2f} ms (one-hot {parts['one_hot']:.2f} ms); "
          f"resume bitwise over {lmt['resume']['arrays']} arrays [{card}]")
    bl, fl, prof = lstm["bucket"], lstm["fixed"], lstm["profile"]
    print(f"lstm summary: config #4 (2x200 LSTM, vocab 10000, batch 32, "
          f"buckets 10-60) BucketingModule.fit one epoch: "
          f"{bl['tokens_s']:.1f} tokens/s steady ({bl['words_s']:.1f} "
          f"words/s), peak {bl['peak_gib']:.2f} GiB, fused step declined "
          f"{bl['declined']}, perplexity {bl['ppl_first']:.1f} -> "
          f"{bl['ppl_last']:.1f}; bench.py's fixed-35 lane "
          f"{fl['tokens_s']:.1f} tokens/s, step {fl['step_ms']:.3f} ms; "
          f"profiled bucket-60 step {prof['kernels']} kernels, busy "
          f"{prof['busy']:.3f}, host {prof['host_ms']:.1f} ms; parity "
          f"worst {lstm['parity']['worst']:.4f}, RNN op cuDNN "
          f"{lstm['rnn']['ms']:.3f} ms vs plain {lstm['rnn']['plain_ms']:.3f}"
          f" ms [{card}]")
    f32, u8, res = imagenet["float32"], imagenet["uint8"], \
        imagenet["resident"]
    print(f"imagenet summary: config #2 (train_imagenet.py ResNet-"
          f"{IMAGENET_LAYERS} v2, fp32, batch {IMAGENET_BATCH}, "
          f"{imagenet['format'][1:].upper()} .rec, {os.cpu_count()} host "
          f"cores) through Module.fit + the h2d ring: fp32 wire "
          f"{f32['images_s']:.1f} images/s (steady "
          f"{f32['steady_images_s']:.1f}), real_vs_resident "
          f"{f32['real_vs_resident']:.3f}, {f32['stalls']} stalls, "
          f"{f32['bytes_batch'] / 1e6:.2f} MB a batch; uint8 wire "
          f"{u8['images_s']:.1f} images/s (steady "
          f"{u8['steady_images_s']:.1f}), real_vs_resident "
          f"{u8['real_vs_resident']:.3f}, {u8['stalls']} stalls, "
          f"{u8['bytes_batch'] / 1e6:.2f} MB a batch; resident "
          f"{res['images_s']:.1f} images/s; iterator alone "
          f"{imagenet['iter_f32']:.1f} (fp32) / {imagenet['iter_u8']:.1f} "
          f"(uint8) images/s; peak {f32['peak_gib']:.2f} GiB; profiled "
          f"step busy {imagenet['profile']['busy']:.3f}, host "
          f"{imagenet['profile']['host_ms']:.1f} ms, h2d overlap "
          f"{imagenet['profile']['overlap_ms']:.3f} of "
          f"{imagenet['profile']['copy_ms']:.3f} ms; 12b worst "
          f"{imagenet['parity']['worst']:.3f} of the tolerance [{card}]")
    fit, dev, s300 = ssd["fit"], ssd["fit_device"], ssd["ssd300"]
    alone = ssd["alone"]
    print(f"ssd summary: config #5 (train_ssd.py SSD-VGG16, 3 classes, "
          f"fp32, batch {SSD_CFG['batch']}, {SSD_CFG['image']}x"
          f"{SSD_CFG['image']}) through Module.fit: {fit['images_s']:.1f} "
          f"images/s over epochs 2-3, step {fit['step_ms']:.2f} ms, peak "
          f"{fit['peak_gib']:.2f} GiB, fused step declined "
          f"{fit['declined']}, CrossEntropy {fit['ce'][0]:.4f} -> "
          f"{fit['ce'][-1]:.4f}, {ssd['kept']} detections decoded; the "
          f"metric on the card: {dev['images_s']:.1f} images/s, declined "
          f"{dev['declined']}; 300x300: {s300['images_s']:.1f} images/s, "
          f"step {s300['step_ms']:.2f} ms, peak {s300['peak_gib']:.2f} GiB; "
          f"profiled step busy {ssd['profile']['busy']:.3f} (128) / "
          f"{ssd['profile300']['busy']:.3f} (300); MultiBoxDetection alone "
          + " / ".join(f"N={a['MultiBoxDetection']['n']} "
                       f"{a['MultiBoxDetection']['device_ms']:.2f} ms device"
                       f" {a['MultiBoxDetection']['launches']} launches"
                       for a in alone.values())
          + f"; from the .rec {ssd['rec']['images_s']:.1f} images/s; 13b "
          f"worst {ssd['parity']['worst']:.3f} of the tolerance [{card}]")
    fit, dist, wd = kvp["dp_fit"], kvp["dist"], kvp["wd"]
    print(f"kvstore summary: 14b train_mnist's mlp on [gpu(0), gpu(0)] "
          f"through kvstore='device': {fit['images_s']:.1f} images/s, step "
          f"{fit['step_ms']:.3f} ms, accuracy {fit['accuracy']:.4f}, 2-bit "
          f"{kvp['dp_2bit']['ties']} near ties; 14c dist_sync 2 workers: "
          f"{dist['steps_s']:.1f} steps/s, push {dist['push_ms']:.3f} ms, "
          f"pull {dist['pull_ms']:.3f} ms, server update "
          f"{dist['server_update_ms']:.3f} ms, 2-bit wire "
          f"{dist['wire_ratio']:.5f} of fp32; 14d wide_deep "
          f"{wd['samples_s']:.1f} samples/s, hit rate {wd['hit_rate']:.4f},"
          f" lookup {wd['lookup_host_ms']:.3f} ms host / "
          f"{wd['lookup_device_ms']:.4f} ms device, push "
          f"{wd['push_ms']:.3f} ms, busy {wd['busy']:.3f} [{card}]")
    n_ops, worst = reg["ops"]
    seq = reg["seq"]
    print(f"registry summary: 15a {n_ops} op names of slice 13 on the card "
          f"vs the CPU, worst {worst[0]:.3f} of the tolerance ({worst[1]}), "
          f"metrics {reg['metrics']:.3f}; 15b config #4 under "
          f"{len(reg['lstm'])} optimizers, bucket-60 tokens/s "
          + ", ".join(f"{k} {v['tokens_s']:.0f}"
                      for k, v in reg["lstm"].items()
                      if v["tokens_s"] is not None)
          + f"; 15c SequentialModule mlp K1 {seq['k1_launches']} launches, "
          f"vs one Module {seq['split_worst']:.3f}, monitor "
          f"{seq['monitor_worst']:.3f}, accuracy {seq['accuracy']:.4f}, "
          f"step {seq['step_ms']:.3f} ms [{card}]")
    print(f"api summary: 16a FeedForward vs Module {api['16a']['vs_module']:.3f}"
          f" of the tolerance; 16b {api['16b']['batches']} served batches "
          f"from the checkpoint dir, worst {api['16b']['worst']:.3f}; 16c "
          f"counters {api['16b']['breaker']['counters']}; 16d shim built in "
          f"{api['16d']['build_s']:.1f} s; 16e {api['16e'][0]['arrays']} "
          f"arrays sha256-equal over {api['16e'][0]['batches']} batches; K1 "
          f"launches {api['k1']}; " + ", ".join(
              f"{k} {v:.1f} s" for k, v in api["times"].items())
          + f" [{card}]")
    lane, srv = zoo["17b"], zoo["17c"]
    zoo_worst = max(v["worst"] for v in zoo["17d"].values())
    k1_share = "not recorded" if lane["k1_share"] is None else \
        f"{lane['k1_share']:.4f}" + (" (estimated: the profiler lost K1)"
                                     if lane.get("k1_share_estimated")
                                     else "")
    print(f"zoo summary: 17a AlexNet card vs CPU at "
          f"{zoo['17a']['worst']:.3f} of the tolerance; 17b AlexNet bf16 "
          f"batch {ALEX_LANE['batch']} through Module.fit "
          f"{lane['images_s']:.1f} images/s, step {lane['step_ms']:.3f} ms, "
          f"peak {lane['peak_gib']:.2f} GiB, K1's share of the profiled "
          f"step's device time {k1_share}; 17c served answers at "
          f"{srv['worst']:.3f} of the tolerance; 17d fp32 batch "
          f"{ZOO17_LANE['batch']} images/s "
          + ", ".join(f"{n} {v['images_s']:.1f}" for n, v in
                      zoo["17d"].items())
          + f", card vs CPU worst {zoo_worst:.3f}; 17e worst {zoo['17e'][0]:.3f} ({zoo['17e'][1]}); K1 launches "
          f"{zoo['k1']}; " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                       zoo["times"].items())
          + f" [{card}]")
    ld, (lb, ll) = loaders["18a"][1], loaders["18b"]
    lg, ls = loaders["18d"], loaders["18e"]
    print(f"loader summary: 18a gluon loader of the {ld['format'][1:]} "
          f".rec, random pipeline over an epoch " + ", ".join(
              f"{w} workers {r:.1f} ({ld['cores'][w]:.2f} cores)"
              for w, r in ld["rates"].items())
          + f" images/s (ImageRecordIter {imagenet['iter_f32']:.1f}); 18b "
          f"AlexNet bf16 fed by DataLoaderIter {ll['images_s']:.1f} "
          f"images/s, loader_vs_resident {ll['loader_vs_resident']:.3f}, "
          f"bridge {'bit for bit' if lb['bitwise'] else 'in tolerance'};"
          f" 18c Estimator.fit {loaders['18c']['images_s']:.1f} images/s; "
          f"18d gluon LM fp32 {lg['fp32']['tokens_s']:.1f} tokens/s (mfu "
          f"{lg['fp32']['mfu']:.4f}, fused_vs_eager "
          f"{lg['fused_vs_eager']:.3f}, gluon_vs_module "
          f"{lg['gluon_vs_module']:.3f}), bf16 {lg['bf16']['tokens_s']:.1f}"
          f", parity worst {lg['parity']['worst']:.3f}; 18e SVRG ce "
          f"{ls['ce'][0]:.4f} -> {ls['ce'][1]:.4f}; K1 launches "
          f"{loaders['k1']}; " + ", ".join(
              f"{k} {v:.1f} s" for k, v in loaders["times"].items())
          + f" [{card}]")
    sa, sb, sc = s17["19a"], s17["19b"], s17["19c"]
    print(f"slice 17 summary: 19a LibSVM at {SPARSE19['features']} "
          f"features through Module.fit, {sa['bytes_batch']:.0f} bytes a "
          f"batch crossed, card vs CPU {sa['worst']:.3f} of the tolerance, "
          f"sparse.dot {sa['dot_ms']:.4f} ms (dense {sa['dense_dot_ms']:.4f})"
          f"; 19b ONNX VGG-16 export {sb['export_s']:.2f} s, import "
          f"{sb['import_s']:.2f} s, {sb['bytes']} bytes, served worst "
          f"{sb['worst']:.3e}, ResNet-50 round trip {sb['resnet']:.4f}; "
          f"19c int8 calibration {sc['calib_s']:.2f} s, {sc['ties']} ties, "
          f"worst {sc['worst']:.3f}, vs fp32 L2 {sc['rel']:.4f} top-1 "
          f"{sc['top1']:.4f}; bucket 32 fp32 {sb['rate']:.1f} / int8 "
          f"{sc['rate']:.1f} images/s; K1 launches {s17['k1']}; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in s17["times"].items())
          + f" [{card}]")
    ra, rb = f20["router"]["20a"], f20["router"]["20b"]
    fc, fd, fe = f20["20c"], f20["20d"], f20["20e"]
    print(f"fleet summary: 20a VGG-16 over 2 local + 2 worker replicas "
          f"{ra['rps']:.1f} requests/s ({ra['images_s']:.1f} images/s), "
          + ", ".join(f"{c} p50 {v['p50_ms']:.1f} p99 {v['p99_ms']:.1f} ms"
                      for c, v in ra["classes"].items())
          + f", worker declared dead {ra['failover_s']:.3f} s after its "
          f"SIGKILL, {ra['failovers']} failovers; 20b rolling swap "
          f"{rb['swap_s']:.2f} s, {rb['versions'][0]} old / "
          f"{rb['versions'][1]} new answers; 20c host declared dead "
          f"{fc['declared_s']:.3f} s after its SIGKILL, backfill "
          f"{fc['backfill_s']} s, spin-ups {fc['spinup_s']} s with builds=0;"
          f" 20d {fd['failovers']} sequences replayed, {fd['ties']} near "
          f"ties; 20e {fe['samples_s']:.1f} samples/s, "
          f"{fe['shard_failovers']} shard failovers; K1 launches "
          f"{f20['k1']}; " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                       f20["times"].items())
          + f" [{card}]")
    ta, tb, tc, td = (f20["21a"], f20["20c"]["21b"], f20["21cd"]["21c"],
                      f20["21cd"]["21d"])
    print(f"telemetry summary: 21a {ta['spans']} spans, {ta['traces']} "
          f"traces, {ta['processes']} processes, 0 orphans, "
          f"{ta['failed_over']} failed over under their trace ids, merged "
          f"in {ta['merge_s']:.2f} s; 21b scrape with a host down "
          f"{tb['ms']:.1f} ms, {tb['series']} series, unreachable "
          f"{tb['unreachable']}; 21c {tc['kernels']} kernels in the trace, "
          f"K1 {tc['k1_seen']} vs {tc['k1']} launches; 21d requests/s off "
          f"{td['off']['rps']:.1f} on {td['on']['rps']:.1f}, p50 "
          f"{td['off']['p50_ms']:.1f}/{td['on']['p50_ms']:.1f} ms, p99 "
          f"{td['off']['p99_ms']:.1f}/{td['on']['p99_ms']:.1f} ms, "
          f"{td['span_ns']:.0f} ns a span [{card}]")
    ga, gb, lc = g22["22a"], g22["22b"], g22["22c"]
    print(f"guardian summary: 22a mlp skip sha256-equal, rollback "
          f"sha256-equal to the clean run, divergence at step "
          f"{ga['diverged'][0]} ({ga['diverged'][1]}), decisions equal the "
          f"CPU's; 22b AlexNet bf16 batch {ALEX_LANE['batch']} step "
          f"{gb['off']['step_ms']:.3f} ms off / {gb['on']['step_ms']:.3f} ms "
          f"on ({gb['cost']:+.4f}), {gb['off']['images_s']:.1f} / "
          f"{gb['on']['images_s']:.1f} images/s, the mlp "
          f"{gb['mlp_cost']:+.4f}, synchronizing calls "
          f"{gb['syncs'][0]} / {gb['syncs'][1]}; 22c {lc['promotions']} "
          f"promotions ({lc['during']} while training), rejected "
          f"{lc['rejected']}, {lc['sent']} requests admitted, {lc['lost']} "
          f"lost, freshness lag {lc['lag']:.3f} s; K1 launches "
          f"{g22['k1']}; " + ", ".join(f"{k} {v:.1f} s" for k, v in
                                        g22["times"].items())
          + f" [{card}]")
    ea, eb, ec, ed = (e23[k] for k in ("23a", "23b", "23c", "23d"))
    print(f"elastic summary: 23a {COLL23_WORKERS} dist_sync workers on the "
          f"collective plane (gloo): the mlp at {ea['dp_worst']:.3f} of "
          f"DP_TOL, {ea['dispatches']} all-reduces a worker; AlexNet fp32 "
          f"all-reduce {ea['allreduce_ms']:.2f} ms for {ea['bytes']} bytes "
          f"= {ea['gb_s']:.3f} GB/s, {ea['steps_s']:.2f} steps/s "
          f"({ea['images_s']:.1f} images/s); 23b first resumed step "
          f"{eb['resume_s']:.3f} s after the server's crash, sha256-equal; "
          f"23c host seen dead {ec['detect_s']:.3f} s after its last step, "
          f"shrink barrier {ec['shrink_s']:.3f} s, restart "
          f"{ec['restart_s']:.3f} s, PARAMS_SHA equal; 23d "
          f"{ed['buckets']} buckets a step, fill {ed['fill']:.3f}, reduce "
          f"{ed['reduce_ms']:.3f} ms, displacement at {ed['worst']:.3f} of "
          f"the tolerance; K1 launches {e23['k1']}; "
          + ", ".join(f"{k} {v:.1f} s" for k, v in e23["times"].items())
          + f" [{card}]")
    pa, pb = p24["24a"], p24["24b"]
    print(f"parallel summary: 24a CustomOp head K1 "
          f"{pa['custom']} launches, bulk init {pa['bulk']['copies']} copy "
          f"({pa['bulk']['bulk_ms']:.1f} ms, unbulked "
          f"{pa['bulk']['plain_ms']:.1f} ms); 24b {WORLD24} gloo ranks in "
          f"{pb['wall_s']:.1f} s, AlexNet dp=2 x tp=2 step "
          f"{pb['step_ms']:.1f} ms, at {pb['worst']:.3f} of the tolerance "
          f"({pb['flips']} flipped units excused), K1 per rank "
          f"{pb['per_rank']}; 24c K1 {p24['24c']}; K1 launches {p24['k1']};"
          f" " + ", ".join(f"{k} {v:.1f} s" for k, v in p24["times"].items())
          + f" [{card}]")
    for key, dt in ((REP, F32), (REP_BF16, BF16)):
        m, k, n, _ = key
        k1[dt]["shape"] = f"{str(dt)[6:]} M={m} K={k} N={n}"
    for key in (ALEX_REP, ALEX_REP_BF16):
        m, k, n, dt = key
        k1[key]["shape"] = f"{str(dt)[6:]} M={m} K={k} N={n} (AlexNet fc6)"
    rep = k1[F32]
    for (m, k, n), label in zip(MLP_K1, ("fc1", "fc2")):
        k1[(m, k, n, F32)]["shape"] = f"float32 M={m} K={k} N={n} (mlp " \
            f"{label})"
    for (m, k, n), _, label in PATH_K1:
        k1[(m, k, n, F32)]["shape"] = f"float32 M={m} K={k} N={n} " \
            f"({label})"
    src = "incubator_mxnet_tpu_torch/csrc/flash_attn.cu"
    tpu = "incubator_mxnet_tpu/ops/flash_attention.py"
    print(json.dumps({"kernels": [{
        "name": "fc_relu", "route": "cuda",
        "source": "incubator_mxnet_tpu_torch/csrc/fc_relu.cu",
        "replaces": "incubator_mxnet_tpu/subgraph/fused_ops.py:29",
        "launches": launches + train_launches + kvp["dp_launches"]
        + kvp["wd_launches"] + seq["k1_launches"] + sum(api["k1"].values())
        + sum(zoo["k1"].values()) + sum(loaders["k1"].values())
        + sum(s17["k1"].values()) + sum(f20["k1"].values())
        + sum(g22["k1"].values()) + sum(e23["k1"].values())
        + sum(p24["k1"].values()),
        "paths": {"serving": launches, "training": train_launches,
                  "data_parallel": kvp["dp_launches"],
                  "wide_deep": kvp["wd_launches"],
                  "sequential_module": seq["k1_launches"],
                  "dist_sync_workers": dist["launches"], **api["k1"],
                  **zoo["k1"], **loaders["k1"], **s17["k1"],
                  **f20["k1"], **g22["k1"], **e23["k1"], **p24["k1"]},
        "max_abs_err": rep["max_abs_err"],
        "ms": rep["ms"], "plain_ms": rep["plain_ms"],
        "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
        "library_ms": rep["library_ms"], "shape": rep["shape"],
        "kernel_route": rep["route"], **dtype_keys("bf16", k1[BF16]),
        **dtype_keys("train_fc1", k1[MLP_K1[0] + (F32,)]),
        **dtype_keys("train_fc2", k1[MLP_K1[1] + (F32,)]),
        **{k: v for shape, prefix, _ in PATH_K1
           for k, v in dtype_keys(prefix, k1[shape + (F32,)]).items()},
        **dtype_keys("alexnet_fc6", k1[ALEX_REP]),
        **dtype_keys("alexnet_fc6_bf16", k1[ALEX_REP_BF16]),
        "train_k1_share": train["mlp"]["k1_share"],
        "alexnet_k1_share": lane["k1_share"]},
        dict(name="flash_fwd", route="cuda", source=src,
             replaces=f"{tpu}:229", launches=k2_launches, **attn[REP_K2],
             **dtype_keys("fp32", attn[REP_K2_F32])),
        dict(name="flash_fwd_stream", route="cuda", source=src,
             replaces=f"{tpu}:180", launches=k3_launches,
             **attn[REP_K3], **dtype_keys("fp32", attn[REP_K3_F32]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
