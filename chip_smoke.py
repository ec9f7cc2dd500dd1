#!/usr/bin/env python3
"""Smoke run of keystone_tpu_torch on one CUDA card (the port's quickest
proof that it still builds, is right and runs end to end on the GPU).

Run from the repository root: ``python3 chip_smoke.py``.  Phases, each of
which raises (and so exits non-zero) on failure:

1. card and build: the card's name and power limit, the CUDA version, and
   the build of every kernel under ``keystone_tpu_torch/csrc`` (``nvcc``)
   and of the native entropy loop (``g++``), all started together;
2. every kernel entry against its plain PyTorch version on the card, at
   the main path's shape and at the odd shapes, timed with CUDA events:
   rect+pool on activations and fused with the Convolver's epilogue (the
   fused entry with every flag on and off, also at the served buckets of
   1, 4, 16 and 64 images and at phase 22's [2048, 43, 43, 100] grid of 48
   px images), the Fisher statistics (also at the served buckets of 1, 4,
   16 and 64 images, each as a share of its bound, and at ImageNetSiftLcsFV's
   shapes, d 64 and k 16 over the SIFT and LCS descriptors of a 375x500
   image, timed with the plain version at 1, 32 and 1,000 images), the
   IDCT (also beside one ``torch.einsum`` call, its library yardstick) and
   the whole pixel decode (``torch.equal`` to the PyTorch composition with
   the IDCT kernel in it, for 4:2:0, 4:2:2, 4:4:4 and grayscale at odd
   sizes, and for phase 22's 2048-image chunk of 48x48 4:2:0 JPEGs, 3x3
   MCUs, which is also timed);
3. the RandomPatchCifar main path at full width (100 filters of 6x6x3,
   pool 14 / stride 13) on seeded synthetic CIFAR-shaped data, 50,000 train
   and 10,000 test images, through
   ``keystone_tpu_torch.workloads.cifar_random_patch.main`` (the fused
   rect+pool entry must carry it, the unfused one must not run), then one
   2048-image chunk's stage times: host preparation, the pageable host ->
   card copy, the cuDNN convolution, the mu/sigma terms, the fused kernel,
   and the unfused chain (epilogue, bf16 cast, rect+pool) as its yardstick;
4. the fitted servable chain applied in batches of 1, 4, 16 and 64, which
   must reproduce the offline test predictions (counted with phase 3 as the
   main path's launches);
5. card against CPU inside the port: one fitted state featurized and solved
   on both devices;
6. the VOCSIFTFisher main path at full width (dense SIFT step 3, 4 scales;
   PCA to 80; a 256-component GMM; 40,960-wide Fisher vectors; 20 classes)
   on seeded synthetic VOC-shaped images, 512 train and 512 test at
   500x375 and 375x500, through
   ``keystone_tpu_torch.workloads.voc_sift_fisher.run``, then its servable
   chain in batches of 1, 4 and 16, which must reproduce the offline test
   scores (counted with the run as the path's launches);
7. card against CPU inside the port: one fitted VOC state, four images
   through SIFT, and from identical descriptors through PCA -> Fisher
   statistics -> features, on both devices;
8. VOCSIFTFisher from JPEG tars with device decode: phase 6's images are
   encoded as baseline JPEGs (q90, 4:2:0) by the numpy encoder of
   ``keystone_tpu_torch.testing.jpeg_encode`` (this machine may have no
   image library) into train/test tars, then run through
   ``voc_sift_fisher.main([... "--streamIngest", "--deviceDecode"])``: the
   native entropy pass on the host, the whole pixel decode on the card in
   two launches of the decode kernel.  Checks: the native backend ran with
   no fallback or skip and the fault ledger (``core.resilience.counters``)
   stayed empty; one chunk's entropy decode equals the encoder's
   coefficients exactly; its card decode equals the unfused PyTorch
   composition on the card bit for bit and is within 1 level of the CPU
   decode with >= 99.9 % of pixels equal; MAP >= 0.5 and within 0.05 of
   phase 6; the kernels' launch counts (the fused decode ran, the IDCT
   entry did not); ``fused_apply`` of the servable chain at batches 1, 4
   and 16 reproduces the offline test scores; and the decode's time at
   batches 1 and 64 beside the unfused composition's and its bound;
9. MnistRandomFFT at BASELINE config 1 (``--numFFTs 4 --blockSize 2048``,
   no ``--lambda``) on seeded synthetic MNIST-shaped data, 60,000 train and
   10,000 test rows of 784 integer pixels in [0, 255] (class stroke maps,
   each pixel inked at random), written as CSVs with the 1-indexed label in
   column 0 and run through
   ``keystone_tpu_torch.workloads.mnist_random_fft.main``: cuFFT features,
   the block solve, streaming evaluation.  Checks: a finite model, train and
   test error below 10 % (chance 90 %); prints the CSV write and load
   seconds, the stage seconds and the peak device memory;
10. the reference's default width, ``--numFFTs 200 --blockSize 2048`` (50
   blocks, 102,400 features), through ``mnist_random_fft.run`` on the same
   rows in memory: the same checks and prints, the peak against its
   estimate and below 80 GB;
11. phase 9's servable chain applied in batches of 1, 4, 16 and 64, which
   must reproduce the offline test predictions exactly, and one fitted
   state carried by ``convert.mnist_to_arrays``/``mnist_from_arrays`` onto
   the card and the CPU: on 2,000 test rows the features agree within
   1e-5·max, the scores within 1e-3·max and the predictions exactly.  The
   launch counters of the three kernels do not move in phases 9-11 (the
   path has no hand kernel, as in the JAX package);
12. TimitPipeline at BASELINE config 4's width (``--numCosines 50``, 4096
   cosine features each, ``--numEpochs 5``, no ``--lambda``) on seeded
   synthetic 440-dim frames of 147 classes, 32,768 train and 8,192 test,
   written as CSVs with sparse 1-indexed label files and run through
   ``keystone_tpu_torch.workloads.timit.main``.  Checks: a finite model,
   test error below 20 % (chance 99.3 %) and the peak device memory below
   80 GB, printed beside its estimate; then a Cauchy run at 4 blocks in
   memory with the same checks;
13. phase 12's servable chain at batches 1, 4, 16 and 64, which must
   reproduce the offline test predictions, and one fitted state carried by
   ``convert.timit_to_arrays``/``timit_from_arrays`` onto the card and the
   CPU: on 1,000 test rows the features agree within 1e-5·max, the scores
   within 1e-3·max and the predictions exactly.  The kernels' launch
   counters do not move in phases 12-13;
14. LinearPixels and RandomCifar through their CLIs on phase 3's files.
   RandomCifar's featurize (the fused featurizer with f32 activations) must
   launch the rect+pool kernel's ``conv_rect_pool`` entry on every chunk and
   never the ``rect_pool`` entry; then one 2048-image chunk of its
   Convolver terms through the entry and its plain version on the card
   (within 1e-5·max), timed beside the bound;
15. NewsgroupsPipeline at BASELINE config 2 (``--nGrams 2
   --commonFeatures 100000``) through
   ``keystone_tpu_torch.workloads.newsgroups.main`` on a seeded synthetic
   20-class tree of half the 20news-bydate split's sizes, 5,657 train and
   3,766 test documents: test error below 20 %, all 100,000 features used,
   the host's text seconds beside the card's scoring seconds, scores at
   batches 1, 4, 16 and 64 equal to the offline ones bit for bit, and the
   naive-Bayes scores card against CPU within 1e-5·max with equal
   predictions on 2,000 documents.  The kernels' counters do not move;
16. one JSON line per the kernels, the card line, and the final JSON
   line, printed last, after phases 17-31;
17. ImageNetSiftLcsFV at BASELINE config 5's width (1,000 classes; SIFT
   step 3 at scale step 1 with bf16 intermediates, then a signed square
   root; LCS (4, 16, 6); PCA to 64; 16 Gaussians; 4,096 features; the
   class-weighted block solve at lambda 6e-5, mixture weight 0.25; top-5
   evaluation) on seeded synthetic BGR images made on the card, 2,000
   train and 1,000 test at 375x500 and 333x500, through
   ``keystone_tpu_torch.workloads.imagenet_sift_lcs_fv.run``: a reckoned
   lower bound of the peak, which the measured peak must reach, top-5
   error below 50 % (chance 99.5 %),
   a finite model, the Fisher statistics kernel launched in both
   branches; then the fitted branches applied to batches of 1, 4 and 16
   test images, which must reproduce the offline scores within 1e-4·max;
18. card against CPU inside the port: one fitted ImageNet state and four
   images through both branches on both devices (descriptors, Fisher
   statistics, features and scores, each against its own bar);
19. ImageNetSiftLcsFV from JPEG tars with device decode: one training
   image per class and 500 test images of phase 17, encoded by the numpy
   encoder into one tar per synset plus a labels file, through
   ``imagenet_sift_lcs_fv.main([... "--streamIngest", "--deviceDecode"])``:
   the native entropy pass with nothing skipped or routed to the host,
   every pass over a split seeing the same survivors, the fused decode
   launched and the IDCT entry not, the statistics kernel in both
   branches, and the top-5 error below 50 % and within 2 points of an
   in-memory run on the same pixel arrays;
20. HOG and DAISY on the card at VOC's shapes: one 64-image batch of
   phase 6's generator at 375x500 and one at 500x375, HOG at bin size 8 on
   the RGB pixels in [0, 1] and DAISY at its defaults on the grayscale.
   Checks: the output shapes (61x45 and 45x61 cells of 32 features;
   10,062 keypoints of 200), all finite, two card runs ``torch.equal``,
   four images on the card ``torch.equal`` to the CPU, and no hand-kernel
   launch; prints each batch's median time (CUDA events), the
   images per second and the phase's peak device memory;
21. StupidBackoffPipeline and CoreNLP on the host: the lines of 2,000
   synthetic documents through ``stupid_backoff.main`` (16 parts, n 3; the
   sharded scores must equal the single table's), then
   ``CoreNLPFeatureExtractor((1, 2, 3))`` over 1,000 of them; prints the
   token, vocabulary and n-gram counts and the host seconds.  Nothing may
   be allocated on the card and no kernel counter may move;
22. RandomPatchCifar at its defaults (100 filters of 6x6x3, pool 14 /
   stride 13, alpha 0.25, lambda 10, chunks of 2048) with the test split
   streamed from a JPEG tar: 50,000 training images of 48x48 in memory
   (phase 3's recipe at 48 px; the loaders reject images under 36 px) and
   10,000 test images encoded by the numpy encoder (q90, 4:2:0) into one
   tar of ``<label>/img_NNNNN.jpg`` members, through
   ``cifar_random_patch.run`` with ``stream_test_tar`` and
   ``device_decode`` under ``core.trace``: the native entropy pass on the
   host, ``decode_pixels`` (K3) and the fused featurizer (K1) on the card.
   Checks: the decode launched at least twice per chunk and the IDCT entry
   never, K1's fused entry at least once per chunk and the unfused entry
   never, the native backend with no skip or fallback, an empty fault
   ledger, test error below 45 %, predictions equal to a run on the same
   pixels decoded in memory by ``decode_batch`` on the card, and a trace
   that ``tools/trace_view.py`` reads holding the five stage spans and the
   ingest spans; prints the per-stage totals and the decode/consume
   overlap.  Then phase 3's fit with ``--trace`` and without, to read what
   tracing costs;
23. the fitted pipelines that phases 3, 6, 8 and 9 saved with
   ``--pipelineFile``, restored through the CLIs (``run`` for VOC in
   memory) with no training data to read: RandomPatchCifar's predictions
   ``np.array_equal`` to phase 3's with K1 launched once per test chunk,
   MnistRandomFFT's equal to phase 9's with no hand kernel, VOCSIFTFisher's
   MAP equal to phase 6's in memory (K2) and to phase 8's from the test tar
   with the decode on the card (K3 in the admitted ``fused_apply``, K2;
   only the test split streams), then the tar run again under
   ``KEYSTONE_HBM_BUDGET=1MB`` (one ``device_decode_admission_denied`` per
   test geometry, the MAP unchanged); then, with the profiler on, the
   restored Cifar run inside one capture window (its trace must name
   ``conv_rect_pool``), the restored tar run and MNIST config 1's fit, and
   prints the ledger rows of the three kernels with their bound shares and
   the ``bcd_fit`` plan and flops audits;
24. the snapshot tiers and decode backends, on phase 22's tar and training
   split and on phase 8's VOC test tar with its restored bundle.  It first
   prints whether ``/usr/include/jpeglib.h`` exists, whether the native
   libjpeg decoder built, and the card.  (a) Featurized tier, on any host:
   Cifar with device decode and ``KEYSTONE_SNAPSHOT_MODE=featurized``; the
   cold test pass launches K3 twice and K1 once per chunk and commits one
   shard per chunk, the warm pass launches neither and reads every shard,
   both predict ``np.array_equal`` to phase 22; one flipped byte in a shard
   is counted ``snapshot_fallback``, predictions unchanged, the snapshot
   rewritten valid; the cold pass is traced.  (b) Where the host has a
   decoder (libjpeg, else PIL): host decode on the thread pool, and of the
   tar's first 2,048 images on spawned workers (equal predictions, every
   worker joined, no ``/dev/shm`` entry left, images/s of each), then the
   device tier
   (``KEYSTONE_SNAPSHOT_MODE=device``: the cold pass decodes on the host and
   writes padded f32 shards, the warm pass copies them to the card,
   ``snapshot_dma_bytes`` > 0, K1 once per chunk, K3 never, predictions
   equal), and VOC restored from the test tar with ``--snapshotDir``, cold
   then warm (MAP equal, K2 on both).  (c) On any host, with both
   decoders turned off, ``decode_image`` raises its typed error; and VOC
   with ``--deviceDecode`` and a decoded snapshot counts
   ``snapshot_mode_unsupported`` with phase 8's MAP.  (d) One ``torch.profiler`` window around a streamed pass (the
   device tier's warm pass, else a device-decode pass): every copy the
   stream made is ``Pinned -> Device`` on one stream that runs no kernel;
   prints the share of copy time that kernels on other streams overlap.
25. serving (``core.serve``, ``core.frontend``, ``core.wire``) on the
   checkpoints phase 23 restores, at the default buckets 1, 4, 16 and 64,
   every bucket a captured CUDA graph.  With the kernel counts set to 0:
   ``--serve`` through the Cifar and MNIST CLIs and ``voc.run`` (phase 6's
   bundle, the most populous shape), each through the shape router with
   answers equal to the offline apply, VOC with every bucket live at
   parity (its products keep each row's bits at any row count); the SLO bench (4 clients, depth 4) on 1,024
   Cifar requests, batched and unbatched answers equal to the offline
   apply; 256 Cifar requests over localhost through ``WireServer`` and
   ``WireClient``, equal; and a warm add of an engine for VOC's second
   shape while Cifar traffic is live, no request lost.  K1 and K2 on this
   path are the wrappers' launches (warm runs, oracles) plus each graph's
   recorded launches times its replays.  Then, counted nowhere: per
   bucket, each chain's replay ``torch.equal`` to the eager chain at that
   batch, both timed per micro-batch (CUDA events, median of 20), and one
   profiled replay per graph kind whose trace names the K1 and K2 kernels
   (a window whose device records the profiler lost is taken again, up to
   three in all).
   Prints each engine's cold start, live buckets and parity, and the
   bench's p50/p99, QPS, batched/unbatched QPS and occupancy.
26. the block solvers' degradation ladder (fused -> stepwise ->
   host_staged) and the resumable block solve, with K2's launches counted
   from 0: (a) VOCSIFTFisher at phase 6's configuration and images through
   ``voc.run`` with ``solve_checkpoint``, the fit killed after block 4 of
   10 (the state writer wrapped for the run), then run again: it must
   resume at epoch 0 block 5, reach phase 6's MAP with test scores within
   1e-5·max of phase 6's (printed whether bit-equal), remove its state, and
   launch K2 in both runs; (b) the same run under two capacity budgets
   read from the reports, below phase 6's fused total and then below the
   stepwise total: ``stepwise``, then ``host_staged``, each MAP within 1e-4
   of phase 6's, with each fit's seconds and peak device memory; (c)
   TimitPipeline at config 4 on phase 12's frames through ``timit.run``
   under a 16 GB budget that denies both device tiers, so the host-staged
   floor streams the 50 blocks from host RAM: a finite model, test error
   within 0.05 points of phase 12's, its peak and solve seconds beside
   phase 12's; (d) the class-weighted solve of seeded features at
   ImageNet's width (2,000 x 4,096, 1,000 classes, config 5's lambda and
   mixture weight; blocks of 1,024) under each tier: within rtol 1e-4,
   atol 1e-5·max of the fused fit, seconds per tier;
27. the optimizer (``core.optimize``), each path with the kernel counts
   set to 0 just before it: (a) RandomPatchCifar with ``--autoCache`` on
   phase 3's files: the plan caches the conv features, K1 launches phase
   3's count plus the optimizer's four one-chunk sample passes (the
   training split featurized once, not twice), predictions
   ``np.array_equal`` to phase 3's; prints the decision table, the fit
   seconds and the peak beside phase 3's; (b) phase 22's tar with the
   ingest autotuner evaluating every chunk: predictions equal to phase
   22's, K3 and K1 launched, the retunes and the final config printed;
   (c) VOCSIFTFisher with ``--autoCache`` on phase 6's images, the
   projected descriptors priced at the default 1 GB/s (the plan's verdict
   printed), then at 1,000 GB/s admitted, then at 1,000 GB/s denied under
   a 16 GB capacity budget: each run phase 6's MAP with test scores
   bit-equal and K2 launched, the peaks printed; (d) phase 17's ImageNetSiftLcsFV bundle,
   saved with ``pipeline_file``, restored and applied to phase 17's test
   split: scores ``np.array_equal`` and the same top-5 error, K2
   launched, seconds beside the fitted run's;
28. the placement search (``core.autoshard``) and the closed lifecycle
   (``core.lifecycle``).  Every fit of the run searches by default, and the
   run's plan-outcome log is a throwaway file (``hermetic_plan_log``), so
   phases 3, 6, 12 and 26 rank as the hand ladder does.  Each path runs
   with the kernel counts set to 0 just before it: (a) RandomPatchCifar
   with ``--autoShard`` on phase 3's files, predictions equal to phase 3's,
   then with ``KEYSTONE_AUTOSHARD=0`` for the hand ladder's solve seconds;
   prints the ranking, the chosen tier, and each candidate's prior,
   calibration and predicted against measured seconds; (b)
   VOCSIFTFisher with ``auto_shard`` on phase 6's images, MAP and scores
   bit-equal to phase 6's; (c) TimitPipeline at config 4 on phase 12's
   frames, searched and then on the hand ladder: the ranking the JAX rules
   give on the card's rates, the chosen tier, predicted against measured
   seconds and the peak, predictions equal to phase 12's; (d)
   ``plan_mispredict``: an out-of-memory error injected at the first run of
   the fused tier of (a)'s fit steps down to the next ranked plan, counted
   once as ``autoshard_stepdown``, predictions equal to (a)'s; (e) the plan
   log (a)-(d) wrote: its row count and ``tools/plan_view.py``'s summary;
   (f) phase 22's fitted chain (from phase 24) saved with its predictions'
   sketch and served through the shape router at the default buckets
   (CUDA graphs); its refit training set committed once from phase 24's
   featurized snapshot of phase 22's tar; then, traffic live and the
   numerics observatory on, a request mix of class 0 alone trips the drift
   monitor, the controller's watcher warm-refits over the committed set
   (``source == "snapshot"``, no K1 launch), validates and hot-swaps: no
   request lost, every answer the incumbent's or the refit's, post-swap
   answers equal to an offline refit on the same data, the refit,
   validate and swap walls printed; the same mix trips the swapped engine
   inside the cooldown, a counted ``refit_suppressed``;
29. the single-process mesh (``parallel.mesh``): 8 slots of ``cuda:0``.
   (a) phase 3's featurize of the 50,000 training images unsharded and
   row-sharded over ``make_mesh(4, 2)`` and ``(8, 1)``: K1 launched once
   per data slot and chunk (chunks of 2048 / data rows; the model slots of
   a data block share the card, its rows and its results), the features
   ``torch.equal`` to the unsharded pass or within phase 5's bf16 bar
   (1e-2 relative), printed which; (b) the Cifar CLI on phase 3's files
   without a mesh and with ``--mesh 1``: model and predictions
   ``torch.equal``; (c) ``cifar.run`` on both meshes: K1 once per data
   slot and chunk (warm chunk, train, test), train and test error within the JAX
   package's bands (0.6 and 1.1 points) of (b)'s, the chosen tier, each
   tier's wall, ``search_seconds`` and the solve's peak; (d) ``--mesh 2``
   raises ``mesh 2x1 needs 2 devices, have 1``; (e) TimitPipeline at
   config 4 on phase 12's frames over ``make_mesh(8, 1)``: every mesh
   tier admitted against an eighth of the card's budget, the chosen tier,
   its peak and error beside phase 12's;
30. the Fisher-vector and text pipelines on the mesh, 8 slots of
   ``cuda:0``, the kernel counts set to 0 before each part: (a)
   VOCSIFTFisher at phase 6's configuration and images through
   ``voc.run`` on ``make_mesh(8, 1)`` and ``(4, 2)``: K2 called once per
   data slot, bucket and split, each call on its slot's rows, its launches
   beside those reckoned from the calls' shapes; the test split's
   descriptors and features (phase 6's fitted bundle) ``torch.equal`` to
   the unsharded pass; test scores ``torch.equal`` to phase 6's or within
   1e-5·max (the solve's row sums over the data axis), printed which; MAP
   equal to phase 6's; the featurize placement and the solve tier chosen,
   seconds and peak; (b) ImageNetSiftLcsFV at phase 17's configuration and
   images through ``inet.run`` on ``(4, 2)``: each BWLS tier's per-slot
   charge beside its budget, the tier that ran, top-1 and top-5 equal to
   phase 17's, scores within rtol 1e-4, atol 1e-5·max, K2 over every data
   slot's rows of both branches and splits, seconds and peak; (c) phase
   26(d)'s class-weighted solve, its inputs row-sharded, on ``(4, 2)`` and
   ``(8, 1)`` through the hand ladder (each runs its own mesh tier): the
   regroup plan's ``usable`` and ``m_pad``, the weights and
   intercept against phase 26(d)'s fused fit (printed whether within rtol
   1e-4, atol 1e-5·max) and against the same fit in f64: no further from
   it than twice the fused fit's distance plus 1e-5 of the largest weight
   (the data axis adds the row sums in another order, and the f32 solve at
   lambda 6e-5 carries that to about 1e-4 of the weights), seconds per
   mesh; (d) NewsgroupsPipeline on (e)'s Newsgroups corpus through
   ``newsgroups.run`` on ``(8, 1)`` and without a mesh: scores
   ``np.array_equal``, the same error, no hand kernel launched; (e) the three CLIs on
   small inputs (VOC: 48 + 48 of phase 6's images as JPEG tars;
   ImageNet: 10 classes, 4 + 2 images each, as tars; Newsgroups: 20 + 10
   documents a class) without a mesh and with ``--mesh 1``: scores
   ``np.array_equal``; each CLI's ``--mesh 2`` raises ``mesh 2x1 needs 2
   devices, have 1``;
31. the spec layouts of the mesh tiers on ``make_mesh(4, 2)`` of 8 slots
   of ``cuda:0``: (a) ``cifar.run`` on phase 3's files in the default
   layout, then once per spec candidate of its 4x2 head
   (``labels=model@dim1``, ``models=rep``, ``labels=rep,models=rep``)
   forced through ``solve_plan=[name]``: K1 once per data slot and chunk
   in each run, the tier that ran, its per-slot charge against the slot
   budget, the solve's wall (host clock after a synchronize), the prior's
   predicted seconds, and the model and predictions ``torch.equal`` to the
   default layout's; (b) every candidate of that searched solve (each mesh
   factorization, each spec assignment, the single-device floor) forced
   once on (a)'s features: the same figures, each spec candidate's model
   ``torch.equal`` to the default layout's on its mesh shape; (c) the same
   for phase 26(d)'s class-weighted solve, row-sharded on ``(4, 2)``: the
   search's ranking, then every candidate once; (d) both searches again
   with ``KEYSTONE_AUTOSHARD_SPECS=0``: no spec candidate, the others in
   the same order, the rankings printed;
32. the auto-Cacher and the reshard checkpoint loader on slots of
   ``cuda:0``: (a) ``cifar.run`` with ``auto_cache`` and ``pipeline_file``
   on phase 3's files on ``(4, 2)``: the cache plan with each decision's
   per-slot charge against the slot budget, K1 once per data slot and
   chunk (the optimizer's four sample passes included, the training split
   featurized once), model and predictions ``torch.equal`` to phase 29's
   4x2 run; then ``cifar.main`` with the same ``--pipelineFile`` (and
   ``--mesh 1``) restores it without reading the training split and
   predicts the same; (b) VOCSIFTFisher with ``auto_cache`` on phase 6's
   images on ``(8, 1)``: scores ``np.array_equal`` to phase 30's 8x1 run,
   K2's launches; (c) (a)'s servable with its scaler mean and block
   weights placed ``data@dim0`` on ``(4, 2)`` and saved under
   ``use_mesh``: the naive load raises ``CheckpointMismatch``;
   ``load_pipeline(mesh=)`` onto ``(2, 1)`` and ``(1, 1)`` (and on ``(1,
   1)`` host-staged under ``KEYSTONE_RESHARD_CHUNK_BYTES=16K``), lowered
   with ``parallel.mesh.replicate`` and applied to the 10,000 test images:
   predictions equal to (a)'s with K1 launched, ``ckpt_reshard`` counted,
   the reshard stats and the load seconds printed; (d) phase 22's tar
   with ``--deviceDecode`` on ``(4, 2)`` with the ingest autotuner
   evaluating every chunk and without it: K3 and K1 launch, predictions
   equal;
33. serving on slots of ``cuda:0`` (``load_engine(mesh=)``, each bucket
   one CUDA graph recording every data slot's rows): (a) phase 3's Cifar
   servable on ``(4, 2)`` at the default buckets: each bucket's parity,
   capture bytes and per-slot charge against the slot budget, K1 recorded
   once per data slot in each bucket's graph, 1,024 requests through a
   mesh-anchored ``ShapeRouter`` ``np.array_equal`` to phase 3's offline
   predictions, K1's launches equal to replays x data slots; (b) the same
   router re-anchored onto ``(2, 1)`` then ``(1, 1)`` under live traffic:
   no request lost, every answer equal, ``mesh_reanchor`` counted twice,
   each ``reshard_wall_s``; (c) phase 6's VOC bundle on ``(8, 1)``: scores
   equal to the single-device engine's (or within 1e-5 of their largest
   magnitude, printed which), K2's launches; (d) a ``MeshEngineFactory``
   under ``KEYSTONE_HBM_BUDGET=64K`` (a slot's 8K is below one 12,288-byte
   request, so every mesh bucket is denied) steps down, counted ``router_mesh_stepdown``, to the
   single-device engine; (e) MnistRandomFFT ``--serve --serveMesh 1x1``
   with phase 9's ``--pipelineFile``: the same predictions as ``--serve``
   alone;
34. multiple processes on the card (``workloads.multihost``: real rank
   subprocesses joined in a ``gloo`` group, each with two mesh slots of
   ``cuda:0``): (a) ``run_two_process_fit_serve`` at the JAX package's
   defaults (2 ranks x 2 shards x 6 images of 48 px, plus the
   single-process reference): bit-identical means, stds, predictions and
   served answers, a mesh spanning the processes, the checkpoint resharded
   across them (``ckpt_reshard_crosshost``) with every window this rank
   holds equal to the fit's, no leaked thread, engine parity, 24 images;
   the group join, fit, reshard, serve and whole walls; (b) the same at 2
   ranks x 8 shards x 256 images (4,096 images): bit-identical, the images
   per second each rank streams through the ingest; (c)
   ``run_host_loss_drill`` with two subprocess hosts serving on the card
   and 24 requests, one host SIGKILLed mid-flight: no request dropped, no
   answer changed, ``fleet_host_lost``, ``dist_reform`` and
   ``host_reanchor`` counted, the re-anchor's wall.  The path runs no
   kernel of K1-K3; their counts are read around it all the same;
35. fleet observability (``core.fleetobs`` over ``workloads.multihost``):
   (a) ``run_obs_capture_drill`` with two ``serve-host`` subprocesses
   serving the drill's scaler from two slots of ``cuda:0`` each, a
   ``FleetCollector`` scraping them every 0.1 s through their serving
   sockets, one member SIGKILLed mid-scrape; (b) the same drill in one
   process, two wire servers on two slot pairs of ``cuda:0``, an abrupt
   socket close standing in for the kill.  Each: fleet counters equal the
   sum of the members' own snapshots, fleet p99 the pick of the pooled
   samples (and within 25 % of numpy's), counters monotone across the
   loss, ``obs_member_lost`` counted, no request dropped or changed,
   exactly one ``obs_member_lost`` incident bundle
   (``keystone.incident/1``) with the survivor's ring and its events
   monotone, one member alive and one lost; the scrape, capture and drill
   walls and the bundle's event count.  No kernel of K1-K3 runs; every
   process's counts are summed all the same;
36. the port's own entry points, each a process of its own started as a
   user would start it: (a) ``python -m keystone_tpu_torch
   RandomPatchCifar`` (no ``--device``: the card by default) on phase 3's
   files with phase 3's flags, ``--pipelineFile`` and ``--serveBench``,
   with a plan-outcome log of its own: K1's fused entry launched at least
   once per chunk in that process (its counts, read at its exit) and the
   unfused one never, train and test errors equal to phase 3's direct
   ``cifar_random_patch.main`` run on the same files, the SLO bench's
   answers bit-identical to the offline apply; (b) ``python -m
   keystone_tpu_torch.tools.serve_bench`` in every mode, on the card:
   in-process, ``--wire --clients 2``, ``--wire --shift``,
   ``--numerics``, ``--kill-device 1`` over 4 slots of ``cuda:0``,
   ``--hosts 2 --kill-host 1 --collect`` and ``--drift-refit``: each exits
   0 with its record ``ok``, no dropped request where the record counts
   them, and never the no-spawn record of ``--hosts``.  Prints each
   record's headline numbers (per-shape p50/p99, QPS, ``wire_p99_ms``,
   ``router_route_overhead_us``, ``reshard_wall_s``, ``reanchor_wall_s``,
   ``drift_to_healthy_wall_s``) and the start-up seconds of each process:
   the tool's (its wall less its record's ``seconds``), each wire client's
   (spawn to connected socket) and the fleet's workers (``bringup_seconds``);
37. the chaos suite on the card (``keystone_tpu_torch.testing.chaos``):
   (a) ``python -m keystone_tpu_torch.tools.chaos_run --device cuda --trace
   DIR`` as a process of its own (run as ``-m`` runs it, through
   ``runpy``, under a hook that prints its K1-K3 counts and the entropy
   backend at its exit) over the tier-1 seeds on MnistRandomFFT, every one
   of the 27 fault families: exit 0, its record ``ok``, every outcome the
   one a healthy system gives, no trace violation; (b) ``run_schedule``
   in this process on ``cuda`` for RandomPatchCifar's seeds 0 (the
   out-of-memory step-down, ``completed_equal``) and 4 (NaN-poisoned
   training images, ``typed_error``), launching K1; (c) K3 launched in
   (a)'s device-decode families.  Prints each family's outcome and seconds,
   the phase's walls and which entropy backend ran.

Without a CUDA card it exits with code 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import glob
import importlib.util
import io
import json
import math
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

# numpy's OpenBLAS runs every product on a spinning thread per core; the
# JPEG encodes of phases 8 and 19 run on 8 threads of their own, and the
# spinning threads take cores from them.  Set before numpy loads its BLAS;
# PyTorch's CPU products use MKL.
os.environ.setdefault("OPENBLAS_NUM_THREADS", "1")

import numpy as np
import torch

from keystone_tpu_torch import _build, convert
from keystone_tpu_torch.core import autoshard
from keystone_tpu_torch.core import frontend as kfrontend
from keystone_tpu_torch.core import memory as kmem
from keystone_tpu_torch.core import numerics as knum
from keystone_tpu_torch.core import optimize as kopt
from keystone_tpu_torch.core import profiler as kprof
from keystone_tpu_torch.core import resilience, trace, wire
from keystone_tpu_torch.core import serve as kserve
from keystone_tpu_torch.core.checkpoint import CheckpointMismatch, load_pipeline, save_pipeline
from keystone_tpu_torch.core import snapshot as ksnap
from keystone_tpu_torch.core.logging import stage_timer
from keystone_tpu_torch.core.pipeline import Pipeline
from keystone_tpu_torch.loaders import image_loaders, native_decode
from keystone_tpu_torch.loaders.cifar import LabeledImageBatch, cifar_loader
from keystone_tpu_torch.loaders.csv_loader import LabeledData
from keystone_tpu_torch.loaders.image_loaders import (
    VOC_NUM_CLASSES,
    LabeledImages,
    MultiLabeledImages,
)
from keystone_tpu_torch.loaders.newsgroups import CLASSES as NG_CLASSES
from keystone_tpu_torch.loaders.newsgroups import newsgroups_loader
from keystone_tpu_torch.loaders.timit import (
    TIMIT_DIMENSION,
    TIMIT_NUM_CLASSES,
    TimitFeaturesData,
    TimitSplit,
)
from keystone_tpu_torch.ops import fisher as fisher_mod
from keystone_tpu_torch.ops import fv_stats as fs
from keystone_tpu_torch.ops import jpeg_device as jd
from keystone_tpu_torch.ops import rect_pool as rp
from keystone_tpu_torch.ops.corenlp import CoreNLPFeatureExtractor
from keystone_tpu_torch.ops.daisy import DaisyExtractor
from keystone_tpu_torch.ops.fisher import _fv_from_stats
from keystone_tpu_torch.ops.hog import HogExtractor
from keystone_tpu_torch.ops.images import convolver_epilogue
from keystone_tpu_torch.ops.lcs import LCSExtractor
from keystone_tpu_torch.ops.sift import SIFTExtractor
from keystone_tpu_torch.ops.stats import SignedHellingerMapper, StandardScaler
from keystone_tpu_torch.solvers.gmm import GaussianMixtureModel
from keystone_tpu_torch.ops.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from keystone_tpu_torch.parallel.mesh import (
    make_mesh,
    padded_shard_rows,
    replicate,
    unshard,
    use_mesh,
)
from keystone_tpu_torch.solvers import block as block_mod
from keystone_tpu_torch.solvers import weighted as weighted_mod
from keystone_tpu_torch.parallel import distributed as kdist
from keystone_tpu_torch.solvers.block import BlockLeastSquaresEstimator, BlockLinearMapper
from keystone_tpu_torch.solvers.weighted import BlockWeightedLeastSquaresEstimator
from keystone_tpu_torch.testing.corpus import write_newsgroups_tree
from keystone_tpu_torch.testing.jpeg_encode import encode_jpeg
from keystone_tpu_torch.utils.platform import resolve_device
from keystone_tpu_torch.workloads import cifar_random_patch as cifar
from keystone_tpu_torch.workloads import imagenet_sift_lcs_fv as inet
from keystone_tpu_torch.workloads import (
    linear_pixels,
    newsgroups,
    random_cifar,
    stupid_backoff,
    timit,
)
from keystone_tpu_torch.workloads import mnist_random_fft as mnist
from keystone_tpu_torch.workloads import voc_sift_fisher as voc
from keystone_tpu_torch.workloads.fv_common import (
    fisher_feature_pipeline,
    grayscale,
    scatter_features,
)

# Published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth and
# the f32 rate outside the tensor cores (3.35e12 B/s, 67e12 flop/s), the
# profiler's rate table entry; every bound below divides a wrapper's stated
# launch cost by them through ``profiler.bound_seconds``.
H100_RATES = kprof.DEVICE_RATES["NVIDIA H100 80GB HBM3"]

N_TRAIN, N_TEST, N_CLASSES = 50_000, 10_000, 10
MAIN_FLAGS = [
    "--numFilters", "100", "--patchSize", "6", "--poolSize", "14",
    "--poolStride", "13", "--alpha", "0.25", "--whitenerSize", "100000",
    "--lambda", "10", "--device", "cuda",
]
# (n, oh, ow, F, stride, pool_size, alpha, max_val): the main path's chunk
# ([2048, 27, 27, 100] conv activations) and two odd shapes (F not a
# multiple of 32, truncated edge windows, odd pool size, max_val != 0).
PROD = (2048, 27, 27, 100, 13, 14, 0.25, 0.0)
# Phase 22's chunk: 48 px images give a 43x43 conv grid (48 - 6 + 1), and
# pool 14 / stride 13 lays 3x3 pools over it (ops/rect_pool.num_pools).
CIFAR48 = (2048, 43, 43, 100, 13, 14, 0.25, 0.0)
ODD = [(64, 20, 24, 7, 4, 6, 0.25, 0.0), (64, 16, 16, 3, 5, 5, 0.1, 0.05)]
# The fused entry's flags (normalize_patches, whitener means), and the
# served buckets it is also timed at.
FUSED_FLAGS = [(True, True), (True, False), (False, True), (False, False)]
K1_SERVED = (1, 4, 16, 64)

# fv_stats (n, d, D, k, ragged): 32 images of the VOC production shape (a
# 500x375 image gives 73,866 descriptors of 80 dims after PCA, k=256; 32
# because the plain version holds [n, k, D] f32 posteriors, 2.4 GB here),
# then ragged counts and a D that is not a multiple of the kernel's tile.
FV_PROD = (32, 80, 73866, 256, False)
FV_ODD = [(3, 24, 700, 8, True), (3, 24, 333, 8, False)]
# fv_stats is also timed at the served buckets of such images.
FV_SERVED = (1, 4, 16, 64)
# fv_stats at ImageNetSiftLcsFV's shapes (d 64, k 16): the descriptors of a
# 375x500 image in the SIFT branch (step 3, scale step 1) and in the LCS
# branch (stride 4, border 16), checked on 8 images (LCS's with ragged
# counts) and timed at one image, at a test chunk of 32 and at a training
# bucket of 1,000 (one launch each).
FV_IMAGENET = {"sift": (SIFTExtractor(scale_step=1).num_descriptors(375, 500), False),
               "lcs": (LCSExtractor(4, 16, 6).num_keypoints(375, 500), True)}
FV_IMAGENET_BATCHES = (1, 32, 1000)

# idct: the main path's luma launch (a 64-image chunk of 375x500 4:2:0 JPEGs
# is [64, 48, 64, 8, 8]), then one block, a ragged count and leading dims.
IDCT_PROD = (64 * 48 * 64, 8, 8)
IDCT_ODD = [(1, 8, 8), (37, 8, 8), (3, 2, 5, 8, 8)]
# The whole decode: (batch, height, width, sampling) -- the main path's
# 64-image 375x500 4:2:0 chunk, then 4:2:2, 4:4:4 and grayscale at odd sizes.
DECODE_CASES = [
    (64, 375, 500, ((2, 2), (1, 1), (1, 1))),
    (2048, 48, 48, ((2, 2), (1, 1), (1, 1))),  # phase 22's chunk: 3x3 MCUs
    (3, 45, 61, ((2, 1), (1, 1), (1, 1))),
    (3, 33, 47, ((1, 1), (1, 1), (1, 1))),
    (3, 33, 47, ((1, 1),)),
    (5, 45, 61, ((2, 2), (1, 1), (1, 1))),
]

# VOCSIFTFisher from JPEG tars (phases 8 and 23): the stream's flags.
VOC_TAR_FLAGS = ["--streamIngest", "--deviceDecode", "--streamBatchSize", "64", "--device", "cuda"]

# VOCSIFTFisher: VOC 2007's two common image sizes (H, W), images per split.
VOC_SHAPES = {(375, 500): 384, (500, 375): 128}
VOC_CONF = dict(desc_dim=80, vocab_size=256, sift_step_size=3, scale_step=0,
                lam=0.5, num_pca_samples=int(1e6), num_gmm_samples=int(1e6),
                seed=42, device="cuda")


# ImageNetSiftLcsFV at BASELINE config 5's width (the workload's defaults:
# 1,000 classes, SIFT step 3 at scale step 1, LCS (4, 16, 6), PCA to 64, 16
# Gaussians, 4,096 features, lambda 6e-5, mixture weight 0.25, one pass) on
# seeded synthetic BGR images at ImageNet's two common sizes, half each;
# the images cut from 1.28 million to 2 train and 1 test per class.  Phase
# 19 encodes one training image per class and 500 test images as JPEGs.
IMAGENET_CLASSES = 1000
IMAGENET_SHAPES = ((375, 500), (333, 500))
IMAGENET_TRAIN_PER_CLASS, IMAGENET_TEST_PER_CLASS = 2, 1
IMAGENET_TAR_TEST = 500


# MnistRandomFFT: MNIST's splits and width; BASELINE config 1 (README
# "Running pipelines"), then the reference's default number of FFTs.
MNIST_TRAIN, MNIST_TEST, MNIST_PIXELS = 60_000, 10_000, 784
MNIST_FLAGS = ["--numFFTs", "4", "--blockSize", "2048", "--device", "cuda"]
MNIST_CONF = dict(num_ffts=4, block_size=2048, device="cuda")  # the same, for run()
MNIST_WIDE_FFTS = 200
MNIST_CARD_VS_CPU_ROWS = 2000

# TimitPipeline at BASELINE config 4's width (50 blocks of 4096 cosine
# features, 5 epochs, lambda 0) on synthetic 440-dim frames of 147 classes;
# the rows cut from TIMIT's two million frames to 32,768 / 8,192.  The
# class centres carry TIMIT_CENTRE_SCALE of each dimension's unit spread.
TIMIT_TRAIN, TIMIT_TEST = 32_768, 8_192
TIMIT_CENTRE_SCALE = 0.3
TIMIT_FLAGS = ["--numCosines", "50", "--gamma", "0.05555", "--rfType", "gaussian",
               "--numEpochs", "5", "--device", "cuda"]
TIMIT_CAUCHY = dict(num_cosines=4, rf_type="cauchy", gamma=0.002)
# The CPU side scores each row through 50 blocks of 4096 x 147 products
# formed elementwise (batch-invariant sums): about 50 s of host time for
# 1,000 rows on the card's host, so the comparison takes 256.
TIMIT_CARD_VS_CPU_ROWS = 256

# RandomCifar at its defaults with lambda 10, on phase 3's files.
RANDOM_CIFAR_FLAGS = [
    "--numFilters", "100", "--patchSize", "6", "--poolSize", "14", "--poolStride", "13",
    "--alpha", "0.25", "--lambda", "10", "--device", "cuda",
]

# NewsgroupsPipeline at BASELINE config 2 on a synthetic tree of half the
# 20news-bydate split's sizes (11,314 / 7,532; halved to keep the script
# inside its time limit: the text pipeline is host-bound Python).
NG_TRAIN, NG_TEST = 5_657, 3_766
NG_FLAGS = ["--nGrams", "2", "--commonFeatures", "100000", "--device", "cuda"]
NG_CARD_VS_CPU_DOCS = 2000

# HOG (bin size 8) and DAISY (the defaults) on one 64-image batch of each
# VOC shape; the expected rows per image (HOG's cells less a border of
# one, DAISY's keypoints from border 16 by stride 4); four images of each
# are held to the CPU bit for bit.
DESC_BATCH = 64
HOG_BIN = 8
DESC_ROWS = {(375, 500): (61 * 45, 117 * 86), (500, 375): (45 * 61, 86 * 117)}
DESC_CARD_VS_CPU = 4

# RandomPatchCifar from a JPEG tar (phase 22): 50,000 train images in
# memory and 10,000 test images in one tar, 48 px (the loaders' MIN_DIM of
# 36 px rules out 32 px JPEGs); the stage and ingest spans its trace holds.
CIFAR_TAR_PX, CIFAR_TAR_TEST = 48, 10_000
TAR_STAGES = ("load", "learn_filters", "featurize", "solve", "eval")
TAR_INGEST_SPANS = ("ingest.produce", "ingest.entropy_decode", "ingest.ring_put",
                    "ingest.ring_get", "ingest.consume")

# StupidBackoffPipeline on the lines of 2,000 synthetic documents (100 per
# Newsgroups class), CoreNLP on 1,000 of them.
LM_DOCS_PER_CLASS = 100
LM_FLAGS = ["--numParts", "16", "--n", "3"]
CORENLP_DOCS = 1000


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` single-call times, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(cost) -> tuple[float, str]:
    """Least time in ms for a launch of ``cost`` (its wrapper's stated
    ``(flops, bytes)``) on the H100's peaks, and what bounds it."""
    seconds, by = kprof.bound_seconds(*cost, H100_RATES)
    return seconds * 1e3, by


def rect_pool_bound(z: torch.Tensor, out_numel: int) -> tuple[float, str]:
    """Least time for the rect+pool work (``rect_pool.rect_pool_cost``)."""
    return bound_ms(rp.rect_pool_cost(z.shape, z.element_size(), out_numel))


def check_rect_pool(shape, dtype, gen, timed: bool) -> dict:
    n, oh, ow, f, stride, size, alpha, max_val = shape
    z = (2.0 * torch.randn((n, oh, ow, f), generator=gen, device="cuda")).to(dtype)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val)
    got = rp.rect_pool(z, **kw)
    torch.cuda.synchronize()
    ref = rp.rect_pool_reference(z, **kw)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    # Both sides read the same (bf16 or f32) input and sum in f32, in
    # another order: rtol 1e-5, atol 1e-4 * max (the JAX kernel's bar).
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4 * scale)
    rec = {"shape": [n, oh, ow, f], "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": (got - ref).abs().max().item()}
    if timed:
        rec["ms"] = cuda_ms(lambda: rp.rect_pool(z, **kw))
        rec["plain_ms"] = cuda_ms(lambda: rp.rect_pool_reference(z, **kw))
        rec["bound_ms"], rec["bound_by"] = rect_pool_bound(z, got.numel())
    log(f"rect_pool {rec}")
    return rec


def conv_terms(n, oh, ow, f, gen, normalize=True, means=True):
    """Seeded Convolver terms at RandomPatchCifar's scale: conv of 0-255
    patches with unit-norm filters, patch means and deviations."""
    conv = 300.0 * torch.randn((n, oh, ow, f), generator=gen, device="cuda")
    mu = 255.0 * torch.rand((n, oh, ow), generator=gen, device="cuda") if normalize else None
    sigma = (5.0 + 75.0 * torch.rand((n, oh, ow), generator=gen, device="cuda")
             if normalize else None)
    fsum = torch.randn((f,), generator=gen, device="cuda")
    fmd = torch.randn((f,), generator=gen, device="cuda") if means else None
    return conv, mu, sigma, fsum, fmd


def conv_rect_pool_bound(terms, out_numel: int) -> tuple[float, str]:
    """Least time for the fused step (``rect_pool.conv_rect_pool_cost``)."""
    conv, mu, _sigma, _fsum, fmd = terms
    return bound_ms(rp.conv_rect_pool_cost(*conv.shape, out_numel, normalize=mu is not None,
                                           means=fmd is not None))


def check_conv_rect_pool(shape, dtype, flags, gen, timed: bool) -> dict:
    n, oh, ow, f, stride, size, alpha, max_val = shape
    terms = conv_terms(n, oh, ow, f, gen, *flags)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val,
              activation_dtype=dtype)
    got = rp.conv_rect_pool(*terms, **kw)
    torch.cuda.synchronize()
    ref = rp.conv_rect_pool_reference(*terms, **kw)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    # Both sides compute each activation with the same bits (the kernel in
    # the plain epilogue's order, IEEE round-to-nearest) and sum in f32 in
    # another order: rtol 1e-5, atol 1e-4 * max (the JAX kernel's bar).
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-4 * scale)
    rec = {"shape": [n, oh, ow, f], "dtype": str(dtype).replace("torch.", ""),
           "normalize_patches": flags[0], "whitener_means": flags[1],
           "max_abs_err": (got - ref).abs().max().item()}
    if timed:
        rec["ms"] = cuda_ms(lambda: rp.conv_rect_pool(*terms, **kw))
        rec["plain_ms"] = cuda_ms(lambda: rp.conv_rect_pool_reference(*terms, **kw))
        rec["bound_ms"], rec["bound_by"] = conv_rect_pool_bound(terms, got.numel())
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"conv_rect_pool {rec}")
    return rec


def time_conv_rect_pool(n: int, gen) -> dict:
    """The fused entry's time on ``n`` images of the production shape (bf16
    activations, every term), and its share of the bound."""
    _, oh, ow, f, stride, size, alpha, max_val = PROD
    terms = conv_terms(n, oh, ow, f, gen)
    kw = dict(pool_stride=stride, pool_size=size, alpha=alpha, max_val=max_val)
    ms = cuda_ms(lambda: rp.conv_rect_pool(*terms, **kw), reps=50)
    bound_ms, _ = conv_rect_pool_bound(terms, n * 4 * 2 * f)
    log(f"conv_rect_pool at batch {n}: {ms:.4f} ms, {100 * bound_ms / ms:.1f} % of its "
        f"{bound_ms:.4f} ms bound")
    return {"ms": ms, "bound_ms": bound_ms, "bound_share": bound_ms / ms}


def fv_stats_bound(n: int, d: int, cols: int, k: int) -> tuple[float, str]:
    """Least time for the statistics (``fv_stats.fv_stats_cost``)."""
    return bound_ms(fs.fv_stats_cost(n, d, cols, k))


def fv_stats_f64(args, n_valid, chunk: int = 8) -> torch.Tensor:
    """The plain version's Fisher vectors on the same inputs in f64, a few
    images at a time (the [n, k, D] posteriors are 1.2 GB per 8 images)."""
    x, counts, means, variances, weights = (
        None if a is None else (a.double() if a.is_floating_point() else a) for a in args
    )
    gmm = (means, variances, weights)
    return torch.cat([
        _fv_from_stats(
            *fs.fv_stats_reference(x[i : i + chunk], None if counts is None else counts[i : i + chunk], *gmm),
            *gmm, n_valid[i : i + chunk].double(),
        )
        for i in range(0, x.shape[0], chunk)
    ])


def time_fv_stats(n: int, gen, d: int = FV_PROD[1], cols: int = FV_PROD[2],
                  k: int = FV_PROD[3], plain: bool = False) -> dict:
    """The kernel's time on ``n`` images of ``[d, cols]`` descriptors (the
    VOC production shape by default), its share of the bound, and with
    ``plain`` the plain version's time on the same inputs."""
    x = torch.randn((n, d, cols), generator=gen, device="cuda")
    means = torch.randn((d, k), generator=gen, device="cuda")
    variances = 0.5 + 1.5 * torch.rand((d, k), generator=gen, device="cuda")
    weights = torch.full((k,), 1.0 / k, device="cuda")
    args = (x, None, means, variances, weights)
    ms = cuda_ms(lambda: fs.fv_stats(*args), reps=10)
    bound_ms, bound_by = fv_stats_bound(n, d, cols, k)
    rec = {"shape": [n, d, cols], "k": k, "ms": ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "bound_share": bound_ms / ms}
    if plain:
        rec["plain_ms"] = cuda_ms(lambda: fs.fv_stats_reference(*args), reps=3, warmup=1)
    del x
    log(f"fv_stats at batch {n} of [{d}, {cols}], k {k}: {ms:.4f} ms, "
        f"{100 * bound_ms / ms:.1f} % of its {bound_ms:.4f} ms bound"
        + (f", plain {rec['plain_ms']:.4f} ms" if plain else ""))
    return rec


def check_fv_stats(shape, gen, timed: bool) -> dict:
    n, d, cols, k, ragged = shape
    x = torch.randn((n, d, cols), generator=gen, device="cuda")
    means = torch.randn((d, k), generator=gen, device="cuda")
    variances = 0.5 + 1.5 * torch.rand((d, k), generator=gen, device="cuda")
    weights = 0.5 + torch.rand((k,), generator=gen, device="cuda")
    weights /= weights.sum()
    counts = (torch.randint(cols // 2, cols + 1, (n,), generator=gen, device="cuda")
              .to(torch.int32) if ragged else None)
    n_valid = (counts.to(torch.float32) if ragged
               else torch.full((n,), float(cols), device="cuda"))
    args = (x, counts, means, variances, weights)
    got = _fv_from_stats(*fs.fv_stats(*args), means, variances, weights, n_valid)
    plain = _fv_from_stats(*fs.fv_stats_reference(*args), means, variances, weights, n_valid)
    torch.cuda.synchronize()
    # Oracle: the plain version in f64 on the same inputs.  The plain f32
    # version sums each of its D-long contractions in one f32 chain and at
    # D = 73,866 drifts past the bar itself; the kernel sums in tiles and
    # stays 10x closer to f64.  Bar: rtol 2e-4, atol 2e-5 * max (the JAX
    # kernel's bar, scaled by the output's largest value).
    ref = fv_stats_f64(args, n_valid)
    scale = ref.abs().max().item()
    torch.testing.assert_close(got.double(), ref, rtol=2e-4, atol=2e-5 * scale)
    rec = {"shape": [n, d, cols], "k": k, "ragged": ragged,
           "max_abs_err": (got.double() - ref).abs().max().item(),
           "plain_f32_max_abs_err": (plain.double() - ref).abs().max().item(),
           "kernel_vs_plain_f32": (got - plain).abs().max().item(),
           "max_abs": scale}
    del ref, got, plain
    if timed:
        rec["ms"] = cuda_ms(lambda: fs.fv_stats(*args), reps=10)
        rec["plain_ms"] = cuda_ms(lambda: fs.fv_stats_reference(*args), reps=5, warmup=1)
        rec["bound_ms"], rec["bound_by"] = fv_stats_bound(n, d, cols, k)
        rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"fv_stats {rec}")
    return rec


def idct_bound(n_blocks: int) -> tuple[float, str]:
    """Least time for the IDCT (``jpeg_device.idct_cost``)."""
    return bound_ms(jd.idct_cost(n_blocks))


def check_idct(shape, gen, timed: bool) -> dict:
    # Dequantised coefficients of a 90-quality JPEG lie within about +-1000.
    x = 200.0 * torch.randn(shape, generator=gen, device="cuda")
    got = jd.idct_blocks(x)
    torch.cuda.synchronize()
    # Oracle: the plain version in f64 on the same inputs (the basis is the
    # same f32 constants).  Bar: rtol 1e-6, atol 2e-6 * max: two 8-term f32
    # sums of terms up to max|x| keep about 16 ulps.
    ref = jd.idct_blocks_reference(x.double())
    scale = ref.abs().max().item()
    torch.testing.assert_close(got.double(), ref, rtol=1e-6, atol=2e-6 * scale)
    rec = {"shape": list(shape), "max_abs_err": (got.double() - ref).abs().max().item(),
           "max_abs": scale}
    if timed:
        a = jd._basis(x.device, torch.float32)
        rec["ms"] = cuda_ms(lambda: jd.idct_blocks(x), reps=50)
        rec["plain_ms"] = cuda_ms(lambda: jd.idct_blocks_reference(x), reps=50)
        rec["library_ms"] = cuda_ms(lambda: torch.einsum("ij,njk,kl->nil", a.T, x, a), reps=50)
        rec["bound_ms"], rec["bound_by"] = idct_bound(x.numel() // 64)
    log(f"idct {rec}")
    return rec


def decode_bound(geom, batch: int) -> tuple[float, str]:
    """Least time for the whole decode (``jpeg_device.decode_pixels_cost``:
    the coefficients and quant tables read once, the pixels written once;
    bytes bound it)."""
    return bound_ms(jd.decode_pixels_cost(geom, batch))


def random_coeff_batch(case, gen):
    """Seeded quantised coefficients of one geometry on the card, scaled as
    a quality-90 encoder leaves them (larger at low frequencies), with a
    quant table per image."""
    b, h, w, sampling = case
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    block_shape = tuple((-(-h // (8 * vmax)) * v, -(-w // (8 * hmax)) * hh)
                        for hh, v in sampling)
    geom = jd.JpegGeometry(h, w, sampling, block_shape)
    freq = torch.arange(8, device="cuda")
    scale = 40.0 / (1.0 + freq[:, None] + freq[None, :])
    coeffs = [(torch.randn((b, by, bx, 8, 8), generator=gen, device="cuda") * scale)
              .round().to(torch.int16) for by, bx in block_shape]
    qt = torch.randint(1, 9, (b, len(sampling), 8, 8), generator=gen, device="cuda").float()
    return geom, coeffs, qt


def check_decode(case, gen) -> dict:
    geom, coeffs, qt = random_coeff_batch(case, gen)
    got = jd.decode_pixels(geom, coeffs, qt)
    torch.cuda.synchronize()
    ref = jd.decode_pixels_reference(geom, coeffs, qt)
    # Bar: bit equality with the composition on the card (the IDCT kernel
    # in it); every step of the kernel rounds as there.
    if not torch.equal(got, ref):
        raise AssertionError(f"decode {case[:3]} {geom.sampling}: {int((got != ref).sum())} "
                             f"pixels differ from the composition")
    rec = {"batch": case[0], "size": [geom.height, geom.width],
           "sampling": [list(s) for s in geom.sampling], "max_abs_err": 0.0}
    log(f"decode {rec}")
    return rec


def time_decode(geom, coeffs, qt) -> dict:
    """The fused decode and the unfused composition on the card, each timed
    alone, and the decode's bound (coefficients already on the card)."""
    rec = {"batch": int(qt.shape[0]),
           "ms": cuda_ms(lambda: jd.decode_pixels(geom, coeffs, qt), reps=50),
           "plain_ms": cuda_ms(lambda: jd.decode_pixels_reference(geom, coeffs, qt), reps=20)}
    rec["bound_ms"], rec["bound_by"] = decode_bound(geom, int(qt.shape[0]))
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"decode timing {rec}")
    return rec


def voc_images(rng, shapes: dict, num_classes: int = VOC_NUM_CLASSES) -> MultiLabeledImages:
    """Seeded VOC-shaped images: BGR f32 in [0, 255].  Each image has a
    primary class and, with probability 0.25, a second one.  A class is a
    colour plus an oriented grating with its own orientation and period;
    the second class's grating covers a random half of the image.  Noise
    and random phases and amplitudes make every image different."""
    palette = np.random.default_rng(1).uniform(50, 205, (num_classes, 3))
    angles = np.pi * np.arange(num_classes) / num_classes
    periods = 6.0 + 3.0 * (np.arange(num_classes) % 5)
    images, labels = [], []
    for (h, w), count in shapes.items():
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        for _ in range(count):
            classes = [int(rng.integers(num_classes))]
            if rng.random() < 0.25:
                classes.append(int((classes[0] + rng.integers(1, num_classes)) % num_classes))
            img = rng.standard_normal((h, w, 3), dtype=np.float32) * 20.0
            img += palette[classes[0]].astype(np.float32)
            for i, c in enumerate(classes):
                wave = np.float32(rng.uniform(40, 70)) * np.sin(
                    (xx * np.cos(angles[c]) + yy * np.sin(angles[c])) * (2 * np.pi / periods[c])
                    + rng.uniform(0, 2 * np.pi)
                )
                if i == 1:  # the second class fills one random half
                    half = (xx < w / 2) if rng.random() < 0.5 else (yy < h / 2)
                    wave *= half ^ bool(rng.random() < 0.5)
                img += wave[:, :, None]
            images.append(np.clip(img, 0, 255))
            labels.append(classes)
    order = rng.permutation(len(images))
    return MultiLabeledImages([images[i] for i in order], [labels[i] for i in order],
                              [f"synthetic/{i:06d}.jpg" for i in range(len(images))])


def write_cifar(path: Path, n: int, rng, palette) -> None:
    """CIFAR-binary records of separable synthetic images: a class colour
    from ``palette`` (shared between splits) plus noise, and a class-
    frequency wave in one channel."""
    xx = np.arange(32, dtype=np.float64)[None, None, :]
    with open(path, "wb") as fh:
        for i in range(0, n, 5000):
            m = min(5000, n - i)
            labels = rng.integers(0, N_CLASSES, m)
            img = palette[labels][:, :, None, None] + rng.normal(0, 25, (m, 3, 32, 32))
            img[np.arange(m), labels % 3] += 30 * np.sin(xx / (2.0 + labels[:, None, None]))
            recs = np.empty((m, 3073), np.uint8)
            recs[:, 0] = labels
            recs[:, 1:] = np.clip(img, 0, 255).astype(np.uint8).reshape(m, -1)
            recs.tofile(fh)


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def featurize_breakdown(featurizer, images: np.ndarray) -> dict:
    """One production chunk's featurize stages: the host's share (preparing
    the numpy block, the pageable host -> card copy, as
    ``cifar_random_patch._chunks`` makes them; host clock around each, ending
    in a synchronize) and the card's (CUDA events): the cuDNN convolution,
    the mu/sigma terms, the fused kernel, the featurizer as the path calls
    it, and the unfused chain of the parent as its yardstick (the Convolver's
    epilogue, the bf16 cast, rect+pool)."""
    conv = featurizer.conv
    kw = dict(pool_stride=featurizer.pool_stride, pool_size=featurizer.pool_size,
              alpha=featurizer.alpha, max_val=featurizer.max_val)
    dtype = featurizer.activation_dtype

    def host_ms(fn, reps=10):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    block = np.ascontiguousarray(images, np.float32)
    batch = torch.from_numpy(block).cuda()
    x = conv._images(batch)
    terms = conv.terms(batch)

    def unfused():
        z = convolver_epilogue(*conv.terms(batch), conv.fsum, conv.filter_means_dot)
        return rp.rect_pool(z.to(dtype), **kw)

    z = convolver_epilogue(*terms, conv.fsum, conv.filter_means_dot)
    fused, plain = featurizer(batch), unfused()
    torch.testing.assert_close(fused, plain, rtol=1e-5, atol=1e-4 * plain.abs().max().item())
    return {
        "chunk": int(batch.shape[0]),
        "host_prepare_ms": host_ms(lambda: np.ascontiguousarray(images, np.float32)),
        "h2d_pageable_ms": host_ms(lambda: torch.from_numpy(block).to("cuda")),
        "h2d_bytes": block.nbytes,
        "cudnn_conv_ms": cuda_ms(lambda: torch.nn.functional.conv2d(x, conv._weight), reps=10),
        "mu_sigma_ms": cuda_ms(lambda: conv.patch_stats(x), reps=10),
        "terms_ms": cuda_ms(lambda: conv.terms(batch), reps=10),
        "fused_kernel_ms": cuda_ms(lambda: rp.conv_rect_pool(
            *terms, conv.fsum, conv.filter_means_dot, activation_dtype=dtype, **kw), reps=10),
        "featurizer_ms": cuda_ms(lambda: featurizer(batch), reps=10),
        "unfused_epilogue_ms": cuda_ms(lambda: convolver_epilogue(
            *terms, conv.fsum, conv.filter_means_dot), reps=10),
        "unfused_cast_ms": cuda_ms(lambda: z.to(dtype), reps=10),
        "unfused_rect_pool_ms": cuda_ms(lambda: rp.rect_pool(z.to(dtype), **kw), reps=10),
        "unfused_featurizer_ms": cuda_ms(unfused, reps=10),
        "featurize_chunk_host_ms": host_ms(
            lambda: cifar.featurize_chunked(featurizer, images, len(images), "cuda"), reps=5),
    }


def run_voc(card: str, stem: Path) -> tuple:
    """Phases 6 and 7: the VOCSIFTFisher main path (its fitted bundle saved
    at ``stem``), its servable apply, and card against CPU.  Returns the
    fv_stats launches of the path, the two splits, the MAP, the run's
    seconds, its test scores and its fit report."""
    rng = np.random.default_rng(7)
    t = time.perf_counter()
    train = voc_images(rng, VOC_SHAPES)
    test = voc_images(rng, VOC_SHAPES)
    log(f"VOC data: {len(train)} train / {len(test)} test images in "
        f"{time.perf_counter() - t:.1f} s")
    conf = voc.SIFTFisherConfig(**VOC_CONF, pipeline_file=str(stem))

    torch.cuda.reset_peak_memory_stats()
    fs.launches = 0
    res = voc.run(conf, train, test)
    fit_launches = fs.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    servable = voc.servable_pipeline(conf, res["bundle"])
    land = [i for i, img in enumerate(test.images) if img.shape[:2] == (375, 500)][:16]
    batch = np.stack([test.images[i] for i in land])
    offline = res["test_scores"][land]
    for chunk in (1, 4, 16):
        served = np.concatenate([
            servable(torch.from_numpy(batch[i : i + chunk]).cuda()).cpu().numpy()
            for i in range(0, len(batch), chunk)
        ])
        err = np.abs(served - offline).max()
        if not err <= 1e-4 * np.abs(offline).max():
            raise AssertionError(f"servable apply at batch {chunk} differs from the "
                                 f"offline scores by {err}")
    main_launches = fs.launches
    need = 2 * len(VOC_SHAPES)  # one FV call per shape bucket per split
    if fit_launches < need:
        raise AssertionError(f"fv_stats launched {fit_launches} times, expected >= {need}")
    if not res["map"] >= 0.5:  # chance is the class prevalence, about 0.06
        raise AssertionError(f"VOC MAP {res['map']} is below 0.5")
    log(json.dumps({
        "main_path": "VOCSIFTFisher", "card": card,
        "train_images": len(train), "test_images": len(test),
        "feature_dim": 2 * conf.desc_dim * conf.vocab_size,
        "map": res["map"], "seconds": res["seconds"],
        **{k: res[k] for k in ("sift_seconds", "pca_seconds", "gmm_seconds",
                               "fisher_seconds", "solve_seconds", "eval_seconds",
                               "featurize_images_per_sec")},
        "peak_memory_gb": peak_gb,
        "fv_stats_launches_fit": fit_launches,
        "fv_stats_launches_serve": main_launches - fit_launches,
    }))

    # 7. Card against CPU inside the port, on one fitted state.
    arrays = convert.voc_to_arrays(servable)
    x = torch.from_numpy(batch[:4])
    fitted = {dev: convert.voc_from_arrays(**arrays, device=dev) for dev in ("cuda", "cpu")}
    f32_sift = SIFTExtractor(step_size=conf.sift_step_size, scale_step=conf.scale_step)
    within, cpu_descs = {}, {}
    for name, sift in (("f32", f32_sift), ("bf16", voc.make_sift(conf))):
        on_card = sift(grayscale(x.cuda())).cpu()
        cpu_descs[name] = sift(grayscale(x))
        within[name] = (on_card - cpu_descs[name]).abs().le(1.0).float().mean().item()
    # From identical (the CPU's f32) descriptors: the statistics, kernel on
    # the card against the plain version on the CPU, at the JAX kernel's bar
    # scaled by each statistic's largest value; then the features of both
    # sides against the f64 chain.  Two f32 chains cannot be held to 1e-3 of
    # each other here: PCA-projected SIFT descriptors are not centred, so the
    # Fisher vector's s2 - 2 mu s1 + (mu^2 - var) s0 cancels, and the signed
    # square root magnifies the near-zero entries; the card must be no
    # further from f64 than the CPU's plain chain (plus 1e-3 * max).
    gmm = {dev: fitted[dev].gmm for dev in fitted}
    pca_desc = {dev: fitted[dev].pca(cpu_descs["f32"].to(dev)) for dev in fitted}
    stats = {dev: [t.cpu() for t in fs.fv_stats(pca_desc[dev], None, gmm[dev].means,
                                                gmm[dev].variances, gmm[dev].weights)]
             for dev in fitted}
    stat_errs = [((a - b).abs().max() / b.abs().max()).item()
                 for a, b in zip(stats["cuda"], stats["cpu"])]
    feats = {dev: fisher_feature_pipeline(gmm[dev])(pca_desc[dev]).cpu() for dev in fitted}
    g64 = [t.double() for t in (gmm["cpu"].means, gmm["cpu"].variances, gmm["cpu"].weights)]
    exact = fisher_feature_pipeline(GaussianMixtureModel(*g64))(pca_desc["cpu"].double())
    scale = exact.abs().max().item()
    card_err = (feats["cuda"].double() - exact).abs().max().item() / scale
    cpu_err = (feats["cpu"].double() - exact).abs().max().item() / scale
    log(f"VOC card vs cpu: SIFT descriptors within +-1: f32 {within['f32']:.6f}, bf16 "
        f"{within['bf16']:.6f} (bound 0.995); FV statistics s0/s1/s2 max rel err "
        f"{stat_errs} (bound 2e-5 + 2e-4); features from f64, max rel err card "
        f"{card_err:.3e}, cpu {cpu_err:.3e}")
    if not min(within.values()) >= 0.995:
        raise AssertionError(f"SIFT descriptors card vs cpu within +-1: {within}")
    for a, b in zip(stats["cuda"], stats["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5 * b.abs().max().item())
    if not card_err <= cpu_err + 1e-3:
        raise AssertionError(f"card features {card_err} further from f64 than the cpu's {cpu_err}")
    return (main_launches, train, test, res["map"], res["seconds"], res["test_scores"],
            res["fit_report"])


JPEG_PREFIX = "VOCdevkit/VOC2007/JPEGImages/"


def write_voc_tars(root: Path, splits: dict) -> dict:
    """Encode each split's images as baseline JPEGs (q90, 4:2:0) into
    ``root/<split>.tar`` under ``JPEG_PREFIX``, with one labels CSV in the
    format ``voc_labels_map`` parses.  Returns member name -> (JPEG bytes,
    encoder coefficients, source image) for the test split."""
    rows = ['"id","class","classname","traintesteval","filename"']
    test_members = {}
    with ThreadPoolExecutor(8) as pool:
        for split, data in splits.items():
            encoded = pool.map(lambda img: encode_jpeg(img, 90, "4:2:0"), data.images)
            with tarfile.open(root / f"{split}.tar", "w") as tf:
                for i, ((jpeg, coeffs), labels) in enumerate(zip(encoded, data.labels)):
                    name = f"{JPEG_PREFIX}{split}_{i:06d}.jpg"
                    info = tarfile.TarInfo(name)
                    info.size = len(jpeg)
                    tf.addfile(info, io.BytesIO(jpeg))
                    rows.extend(f'{len(rows)},{c + 1},"c{c}",1,"{name}"' for c in labels)
                    if split == "test":
                        test_members[name] = (jpeg, coeffs, data.images[i])
    (root / "labels.csv").write_text("\n".join(rows) + "\n")
    return test_members


def run_voc_tar(card: str, train, test, memory_map: float, root: Path) -> tuple:
    """Phase 8: VOCSIFTFisher from JPEG tars (written under ``root``, kept
    for phase 23) through ``--streamIngest --deviceDecode``, its fitted
    bundle saved at ``root / "bundle"``.  Returns the decode and fv_stats
    launches of the path, the decode's timings at batches 1 and 64, the MAP
    and the run's seconds."""
    root.mkdir(parents=True, exist_ok=True)
    t = time.perf_counter()
    members = write_voc_tars(root, {"train": train, "test": test})
    encode_secs = time.perf_counter() - t
    jpeg_bytes = (root / "test.tar").stat().st_size / len(test)
    log(f"VOC JPEG tars: {len(train)} + {len(test)} images encoded in {encode_secs:.1f} s")

    resilience.counters.reset()
    torch.cuda.reset_peak_memory_stats()
    jd.launches = jd.decode_launches = fs.launches = 0
    res = voc.main([
        "--trainLocation", str(root / "train.tar"), "--testLocation", str(root / "test.tar"),
        "--labelPath", str(root / "labels.csv"), *VOC_TAR_FLAGS,
        "--pipelineFile", str(root / "bundle"),
    ])
    fit_decode, fit_fv = jd.decode_launches, fs.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # (f) the servable chain fed coefficient batches of one geometry.
    conf = voc.SIFTFisherConfig(device="cuda")
    servable = voc.servable_pipeline(conf, res["bundle"])
    order = {name: i for i, name in enumerate(res["test_filenames"])}
    chunk = [n for n in res["test_filenames"] if members[n][2].shape[:2] == (375, 500)][:64]
    images = [jd.entropy_decode(members[n][0], backend="native") for n in chunk]
    coeffs, qt = jd.stack_coeff_images(images)
    geom = images[0].geom
    offline = res["test_scores"][[order[n] for n in chunk[:16]]]
    for b in (1, 4, 16):
        served = np.concatenate([
            jd.fused_apply(servable, geom, [c[i : i + b] for c in coeffs], qt[i : i + b],
                           "cuda").cpu().numpy()
            for i in range(0, 16, b)
        ])
        err = np.abs(served - offline).max()
        if not err <= 1e-4 * np.abs(offline).max():
            raise AssertionError(f"fused_apply at batch {b} differs from the offline "
                                 f"scores by {err}")
    decode_launches, fv_launches, idct_launches = jd.decode_launches, fs.launches, jd.launches

    stats = res["ingest"]
    chunks = sum(s["batches"] for s in stats.values())
    # (a) the native entropy pass ran, with nothing skipped or routed away.
    for split, st in stats.items():
        if st["entropy_backend"] != "native":
            raise AssertionError(f"{split}: entropy backend {st['entropy_backend']!r}")
        if st["skipped"] or st["device_fallbacks"] or st["entropy_corrupt"]:
            raise AssertionError(f"{split}: skips or fallbacks in the stream: {st}")
    if resilience.counters.snapshot():
        raise AssertionError(f"counted events: {resilience.counters.snapshot()}")
    # (b) one chunk's entropy decode against the encoder's coefficients.
    for name, img in zip(chunk, images):
        if not all(np.array_equal(a, b) for a, b in zip(img.coeffs, members[name][1])):
            raise AssertionError(f"{name}: entropy decode != the encoder's coefficients")
    # (c) that chunk decoded on the card: bit for bit the unfused composition
    # on the card, and against the port's CPU decode.
    dev_coeffs = [torch.from_numpy(c).cuda() for c in coeffs]
    dev_qt = torch.from_numpy(qt).cuda()
    fused = jd.decode_pixels(geom, dev_coeffs, dev_qt)
    if not torch.equal(fused, jd.decode_pixels_reference(geom, dev_coeffs, dev_qt)):
        raise AssertionError("card decode of the chunk differs from the unfused composition")
    on_card = jd.decode_batch(geom, coeffs, qt, "cuda").cpu()
    on_cpu = jd.decode_batch(geom, coeffs, qt, "cpu")
    diff = (on_card - on_cpu).abs()
    equal = diff.eq(0).float().mean().item()
    if not (diff.max().item() <= 1.0 and equal >= 0.999):
        raise AssertionError(f"card decode vs cpu: max {diff.max().item()}, equal {equal}")
    source = torch.from_numpy(np.stack([members[n][2] for n in chunk]))
    source_err = (on_card - source).abs().mean().item()
    # (d) accuracy, against the in-memory run of phase 6 on the same images.
    if not (res["map"] >= 0.5 and abs(res["map"] - memory_map) <= 0.05):
        raise AssertionError(f"VOC MAP from JPEG tars {res['map']} (in memory {memory_map})")
    # (e) the path went through the fused decode (two launches a chunk) and
    # the statistics kernel, and never through the IDCT entry on its own.
    if not (fit_decode >= 2 * chunks and fv_launches >= chunks and idct_launches == 0):
        raise AssertionError(f"launches: decode {fit_decode}, fv_stats {fv_launches}, "
                             f"idct {idct_launches}, {chunks} chunks")
    # Device decode of one production chunk and of one image, coefficients
    # already on the card (these launches are measurements, not the path's).
    decode_times = {b: time_decode(geom, [c[:b] for c in dev_coeffs], dev_qt[:b])
                    for b in (1, len(chunk))}
    decode_ms = decode_times[len(chunk)]["ms"]
    h2d_ms = cuda_ms(lambda: [torch.from_numpy(c).cuda() for c in coeffs], reps=10)
    log(json.dumps({
        "main_path": "VOCSIFTFisher from JPEG tars, --streamIngest --deviceDecode",
        "card": card, "train_images": len(train), "test_images": len(test),
        "map": res["map"], "map_in_memory": memory_map, "seconds": res["seconds"],
        **{k: res[k] for k in ("sift_seconds", "pca_seconds", "gmm_seconds",
                               "fisher_seconds", "solve_seconds", "eval_seconds",
                               "featurize_images_per_sec")},
        "peak_memory_gb": peak_gb, "encode_seconds": encode_secs,
        "jpeg_bytes_per_image": jpeg_bytes,
        "entropy_backend": stats["train"]["entropy_backend"],
        "host_entropy_thread_seconds": {k: s["decode_seconds"] for k, s in stats.items()},
        "chunks": chunks, "device_decode_ms_per_chunk": decode_ms,
        "unfused_decode_ms_per_chunk": decode_times[len(chunk)]["plain_ms"],
        "device_decode_seconds_est": decode_ms * chunks / 1e3,
        "coeff_h2d_ms_per_chunk": h2d_ms,
        "coeff_bytes_per_image": geom.coeff_bytes(),
        "pixel_bytes_per_image": geom.height * geom.width * 3 * 4,
        "decode_launches_fit": fit_decode, "decode_launches_serve": decode_launches - fit_decode,
        "idct_launches": idct_launches,
        "fv_stats_launches_fit": fit_fv, "fv_stats_launches_serve": fv_launches - fit_fv,
        "card_vs_cpu_decode_max_abs": diff.max().item(), "card_vs_cpu_decode_equal": equal,
        "decoded_vs_source_mean_abs": source_err,
    }))
    return decode_launches, fv_launches, decode_times, res["map"], res["seconds"]


def mnist_stroke_maps(rng) -> np.ndarray:
    """Ten seeded class maps on the 28x28 grid, each five Gaussian blobs
    (a stroke's ink probability, 0 far from the blobs), flattened to 784."""
    yy, xx = np.mgrid[0:28, 0:28]
    maps = np.zeros((10, 28, 28))
    for c in range(10):
        for _ in range(5):
            cy, cx = rng.uniform(6, 22, 2)
            s = rng.uniform(1.5, 3.0)
            maps[c] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return np.clip(maps, 0, 1).reshape(10, MNIST_PIXELS)


def mnist_rows(rng, n: int, maps: np.ndarray) -> np.ndarray:
    """``n`` MNIST-shaped rows: the 1-indexed label, then 784 integer pixels
    in [0, 255].  A pixel is inked with probability 0.7 times its class map,
    at a level in [128, 255], else 0: about 13 % of pixels are inked (MNIST:
    19 %), and pixel means stay below their spread, as in MNIST, so no
    rectified FFT feature is zero on every row."""
    labels = rng.integers(0, 10, n)
    ink = rng.random((n, MNIST_PIXELS)) < 0.7 * maps[labels]
    pixels = np.rint(ink * rng.uniform(128, 255, (n, MNIST_PIXELS)))
    return np.column_stack([labels + 1, pixels]).astype(np.int64)


def write_csv(path: Path, rows: np.ndarray) -> None:
    """Integer rows as comma-separated text, the reference's CSV layout."""
    text = np.array([str(i) for i in range(int(rows.max()) + 1)])
    with open(path, "w") as fh:
        for i in range(0, len(rows), 5000):
            fh.write("\n".join(map(",".join, text[rows[i : i + 5000]].tolist())) + "\n")


def kernel_launches() -> dict:
    return {"rect_pool": rp.launches, "conv_rect_pool": rp.fused_launches,
            "fv_stats": fs.launches, "idct_blocks": jd.launches,
            "decode_pixels": jd.decode_launches}


def mnist_record(res: dict, peak_gb: float) -> dict:
    """The run's errors, stage seconds and peak memory; raises unless the
    model is finite and both errors are below 10 % (chance is 90 %)."""
    model = res["servable"].nodes[1]
    if not all(bool(torch.isfinite(t).all()) for t in [*model.xs, model.b]):
        raise AssertionError("MnistRandomFFT model is not finite")
    if not (res["train_error"] < 10.0 and res["test_error"] < 10.0):
        raise AssertionError(f"MnistRandomFFT errors {res['train_error']}% / "
                             f"{res['test_error']}% are not below 10%")
    return {
        "features": sum(int(x.shape[0]) for x in model.xs), "blocks": len(model.xs),
        "train_error": res["train_error"], "test_error": res["test_error"],
        **{k: res[k] for k in ("featurize_seconds", "featurize_examples_per_sec",
                               "solve_seconds", "eval_seconds", "seconds")},
        "peak_memory_gb": peak_gb,
    }


def run_mnist(card: str, root: Path) -> dict:
    """Phases 9-11: MnistRandomFFT at BASELINE config 1 through the CLI
    (CSVs and the fitted servable chain under ``root``, kept for phase
    23), at the reference's default width in memory, then its servable
    apply and card against CPU.  No hand kernel may launch in them.
    Returns what phase 23 restores and refits: the test CSV, the
    checkpoint stem, the offline predictions, the fit's seconds and the
    splits in memory."""
    rng = np.random.default_rng(11)
    maps = mnist_stroke_maps(rng)
    train_rows = mnist_rows(rng, MNIST_TRAIN, maps)
    test_rows = mnist_rows(rng, MNIST_TEST, maps)
    before = kernel_launches()
    torch.cuda.empty_cache()

    # 9. BASELINE config 1 from CSV files, through the CLI.
    root.mkdir(parents=True, exist_ok=True)
    train_path, test_path = root / "train.csv", root / "test.csv"
    t = time.perf_counter()
    write_csv(train_path, train_rows)
    write_csv(test_path, test_rows)
    write_secs = time.perf_counter() - t
    csv_bytes = train_path.stat().st_size + test_path.stat().st_size
    torch.cuda.reset_peak_memory_stats()
    res = mnist.main(["--trainLocation", str(train_path), "--testLocation", str(test_path),
                      *MNIST_FLAGS, "--pipelineFile", str(root / "servable")])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    servable, offline = res["servable"], res["test_predictions"]
    fit_seconds = res["seconds"]
    log(json.dumps({
        "main_path": "MnistRandomFFT BASELINE config 1 (--numFFTs 4 --blockSize 2048)",
        "card": card, "train_rows": MNIST_TRAIN, "test_rows": MNIST_TEST,
        "csv_write_seconds": write_secs, "csv_bytes": csv_bytes,
        "csv_load_seconds": res["load_seconds"], **mnist_record(res, peak_gb),
    }))
    del res

    # 10. The reference's default width on the same rows, in memory.
    train = LabeledData.from_rows(train_rows.astype(np.float32), one_indexed=True)
    test = LabeledData.from_rows(test_rows.astype(np.float32), one_indexed=True)
    conf = mnist.MnistRandomFFTConfig(num_ffts=MNIST_WIDE_FFTS, block_size=2048, device="cuda")
    groups = -(-MNIST_WIDE_FFTS // (conf.block_size // 512))
    # The train features as a list, and their concatenation in the fit, then
    # the test features: 4 bytes each.
    estimate_gb = (2 * MNIST_TRAIN + MNIST_TEST) * groups * conf.block_size * 4 / 1e9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    wide = mnist.run(conf, train, test)
    wide_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rec = mnist_record(wide, wide_peak_gb)
    if not wide_peak_gb < 80.0:
        raise AssertionError(f"--numFFTs {MNIST_WIDE_FFTS} peaked at {wide_peak_gb} GB")
    log(json.dumps({
        "main_path": f"MnistRandomFFT --numFFTs {MNIST_WIDE_FFTS} --blockSize 2048 (in memory)",
        "card": card, "train_rows": MNIST_TRAIN, "test_rows": MNIST_TEST, **rec,
        "peak_estimate_gb": estimate_gb,
    }))
    del wide
    torch.cuda.empty_cache()

    # 11. The servable chain at served batches, then card against CPU.
    x = torch.from_numpy(test.data[:256])
    for chunk in (1, 4, 16, 64):
        served = np.concatenate([servable(x[i : i + chunk].cuda()).cpu().numpy()
                                 for i in range(0, len(x), chunk)])
        if not np.array_equal(served, offline[:256]):
            raise AssertionError(f"MNIST servable apply at batch {chunk} != offline predictions")
    arrays = convert.mnist_to_arrays(servable)
    rows = torch.from_numpy(test.data[:MNIST_CARD_VS_CPU_ROWS])
    out = {}
    for dev in ("cuda", "cpu"):
        fitted = convert.mnist_from_arrays(**arrays, device=dev)
        feats = fitted.servable.nodes[0](rows.to(dev))
        scores = fitted.model(feats)
        out[dev] = (feats.cpu(), scores.cpu(), MaxClassifier()(scores).cpu())
    feat_err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    feat_max = out["cpu"][0].abs().max().item()
    score_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    score_max = out["cpu"][1].abs().max().item()
    differ = int((out["cuda"][2] != out["cpu"][2]).sum())
    log(f"MNIST card vs cpu on {len(rows)} rows: features max abs err {feat_err:.4e} of max "
        f"{feat_max:.4e} (bound 1e-5·max), scores {score_err:.4e} of max {score_max:.4e} "
        f"(bound 1e-3·max), {differ} predictions differ (bound 0)")
    if not (feat_err <= 1e-5 * feat_max and score_err <= 1e-3 * score_max and differ == 0):
        raise AssertionError("MNIST card and CPU disagree beyond the bounds")
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"hand kernels launched in the MNIST phases: {before} -> {after}")
    log(f"MNIST phases: kernel launch counters unchanged {after}")
    return {"test_csv": test_path, "stem": root / "servable", "predictions": offline,
            "seconds": fit_seconds, "train": train, "test": test}


def timit_split(rng, n: int, centres: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``n`` synthetic phone frames: a class centre plus Gaussian noise per
    frame, with the per-dimension variance 1 (centre share TIMIT_CENTRE_SCALE
    squared), rounded to 0.01 as the CSV stores them.  Returns (frames f32
    [n, 440], 0-indexed labels)."""
    labels = rng.integers(0, TIMIT_NUM_CLASSES, n)
    noise = math.sqrt(1.0 - TIMIT_CENTRE_SCALE**2)
    frames = centres[labels] + noise * rng.standard_normal((n, TIMIT_DIMENSION))
    hundredths = np.clip(np.rint(frames * 100), -999, 999).astype(np.int64)
    return (hundredths / 100.0).astype(np.float32), labels


def write_timit_split(data_path: Path, labels_path: Path, frames: np.ndarray,
                      labels: np.ndarray) -> None:
    """Frames as comma-separated text with two decimals, and the sparse
    1-indexed ``row label`` file, the reference's TIMIT layout."""
    text = np.array([f"{k / 100:.2f}" for k in range(-999, 1000)])
    codes = np.rint(frames * 100).astype(np.int64) + 999
    with open(data_path, "w") as fh:
        for i in range(0, len(codes), 4096):
            fh.write("\n".join(map(",".join, text[codes[i : i + 4096]].tolist())) + "\n")
    labels_path.write_text("".join(f"{i + 1} {c + 1}\n" for i, c in enumerate(labels)))


def timit_record(res: dict, peak_gb: float, estimate_gb: float) -> dict:
    """The run's error, stage seconds and peak memory; raises unless the
    model is finite, the test error is below 20 % (chance 146/147) and the
    peak is below 80 GB."""
    model = res["servable"].nodes[1]
    if not all(bool(torch.isfinite(t).all()) for t in [*model.xs, model.b]):
        raise AssertionError("TIMIT model is not finite")
    if not res["test_error"] < 20.0:
        raise AssertionError(f"TIMIT test error {res['test_error']}% is not below 20%")
    if not peak_gb < 80.0:
        raise AssertionError(f"TIMIT peaked at {peak_gb} GB")
    return {
        "features": sum(int(x.shape[0]) for x in model.xs), "blocks": len(model.xs),
        "test_error": res["test_error"],
        **{k: res[k] for k in ("featurize_seconds", "solve_seconds", "eval_seconds", "seconds")},
        "peak_memory_gb": peak_gb, "peak_estimate_gb": estimate_gb,
    }


def timit_peak_estimate(n: int, blocks: int, width: int) -> float:
    """GB the fit holds at its peak: the training blocks and their
    concatenation, the blocks' Cholesky factors, and three centred blocks
    (the one in use, the next, and the centring's intermediate)."""
    return (2 * n * blocks * width + blocks * width * width + 3 * n * width) * 4 / 1e9


def run_timit(card: str) -> dict:
    """Phases 12-13: TimitPipeline at BASELINE config 4 through the CLI on
    CSVs, a Cauchy run at depth 4, then card against CPU and the servable
    chain at served batches.  No hand kernel may launch in them.  Returns
    phase 12's record and its frames (phase 26 refits them)."""
    rng = np.random.default_rng(13)
    centres = rng.normal(0.0, TIMIT_CENTRE_SCALE, (TIMIT_NUM_CLASSES, TIMIT_DIMENSION))
    train_frames, train_labels = timit_split(rng, TIMIT_TRAIN, centres)
    test_frames, test_labels = timit_split(rng, TIMIT_TEST, centres)
    before = kernel_launches()
    torch.cuda.empty_cache()

    # 12. BASELINE config 4 from CSV files, through the CLI.
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        paths = [Path(tmp) / name for name in ("train.csv", "train.labels", "test.csv",
                                               "test.labels")]
        t = time.perf_counter()
        write_timit_split(paths[0], paths[1], train_frames, train_labels)
        write_timit_split(paths[2], paths[3], test_frames, test_labels)
        write_secs = time.perf_counter() - t
        csv_bytes = sum(p.stat().st_size for p in paths)
        torch.cuda.reset_peak_memory_stats()
        flags = ["--trainDataLocation", "--trainLabelsLocation", "--testDataLocation",
                 "--testLabelsLocation"]
        res = timit.main([a for pair in zip(flags, map(str, paths)) for a in pair]
                         + TIMIT_FLAGS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    estimate_gb = timit_peak_estimate(TIMIT_TRAIN, 50, 4096)
    servable, offline = res["servable"], res["test_scores"].argmax(axis=1)
    rec12 = timit_record(res, peak_gb, estimate_gb)
    log(json.dumps({
        "main_path": "TimitPipeline BASELINE config 4 (--numCosines 50, 4096 features each, "
                     "--numEpochs 5, lambda 0)",
        "card": card, "train_rows": TIMIT_TRAIN, "test_rows": TIMIT_TEST,
        "csv_write_seconds": write_secs, "csv_bytes": csv_bytes,
        "csv_load_seconds": res["load_seconds"], **rec12,
    }))
    del res
    torch.cuda.empty_cache()

    # The other draw: Cauchy W at depth 4, in memory.  Its kernel is
    # exp(-gamma * L1 distance): at gamma 0.05555 any two 440-dim frames are
    # ~e^-27 apart, so the run uses a gamma that suits the frames' scale.
    data = TimitFeaturesData(TimitSplit(train_frames, train_labels.astype(np.int32)),
                             TimitSplit(test_frames, test_labels.astype(np.int32)))
    conf = timit.TimitConfig(**TIMIT_CAUCHY, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    cauchy = timit.run(conf, data)
    cauchy_peak = torch.cuda.max_memory_allocated() / 1e9
    log(json.dumps({
        "main_path": f"TimitPipeline --rfType cauchy --numCosines {conf.num_cosines} "
                     f"--gamma {conf.gamma} (in memory)",
        "card": card, **timit_record(cauchy, cauchy_peak,
                                     timit_peak_estimate(TIMIT_TRAIN, conf.num_cosines, 4096)),
    }))
    del cauchy
    torch.cuda.empty_cache()

    # 13. Served batches, then card against CPU on one fitted state.
    x = torch.from_numpy(test_frames[:256])
    for chunk in (1, 4, 16, 64):
        served = np.concatenate([servable(x[i : i + chunk].cuda()).cpu().numpy()
                                 for i in range(0, len(x), chunk)])
        if not np.array_equal(served, offline[:256]):
            raise AssertionError(f"TIMIT servable apply at batch {chunk} != offline predictions")
    arrays = convert.timit_to_arrays(servable)
    del servable
    rows = torch.from_numpy(test_frames[:TIMIT_CARD_VS_CPU_ROWS])
    out = {}
    for dev in ("cuda", "cpu"):
        fitted = convert.timit_from_arrays(**arrays, device=dev)
        feats = fitted.servable.nodes[0](rows.to(dev))
        scores = fitted.model(feats)
        out[dev] = (feats.cpu(), scores.cpu(), MaxClassifier()(scores).cpu())
        del fitted, feats, scores
    feat_err = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    feat_max = out["cpu"][0].abs().max().item()
    score_err = (out["cuda"][1] - out["cpu"][1]).abs().max().item()
    score_max = out["cpu"][1].abs().max().item()
    differ = int((out["cuda"][2] != out["cpu"][2]).sum())
    log(f"TIMIT card vs cpu on {len(rows)} rows: features max abs err {feat_err:.4e} of max "
        f"{feat_max:.4e} (bound 1e-5·max), scores {score_err:.4e} of max {score_max:.4e} "
        f"(bound 1e-3·max), {differ} predictions differ (bound 0)")
    if not (feat_err <= 1e-5 * feat_max and score_err <= 1e-3 * score_max and differ == 0):
        raise AssertionError("TIMIT card and CPU disagree beyond the bounds")
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"hand kernels launched in the TIMIT phases: {before} -> {after}")
    log(f"TIMIT phases: kernel launch counters unchanged {after}")
    return {**rec12, "data": data, "predictions": offline}


def run_cifar_variants(card: str, train_path: Path, test_path: Path) -> dict:
    """Phase 14: LinearPixels and RandomCifar through their CLIs on phase
    3's files; RandomCifar's featurize must go through the conv_rect_pool
    entry of the rect+pool kernel (f32 activations) and never through the
    rect_pool entry.  Then one 2048-image chunk's Convolver terms through
    the entry and its plain version on the card.  Returns the entry's
    record on that chunk, with RandomCifar's launches."""
    before = kernel_launches()
    lp = linear_pixels.main(["--trainLocation", str(train_path),
                             "--testLocation", str(test_path), "--device", "cuda"])
    if kernel_launches() != before:
        raise AssertionError("LinearPixels launched a hand kernel")
    lp_error = 100.0 * (1.0 - lp["test_accuracy"])
    rp.launches = rp.fused_launches = 0
    rc = random_cifar.main(["--trainLocation", str(train_path),
                            "--testLocation", str(test_path), *RANDOM_CIFAR_FLAGS])
    rc_fused, rc_unfused = rp.fused_launches, rp.launches
    need = math.ceil(N_TRAIN / 2048) + math.ceil(N_TEST / 2048)
    if rc_fused < need or rc_unfused:
        raise AssertionError(f"RandomCifar: conv_rect_pool launched {rc_fused} times, expected "
                             f">= {need}; rect_pool {rc_unfused} times, expected 0")
    if not (lp_error < 45.0 and rc["test_error"] < 45.0):  # chance is 90%
        raise AssertionError(f"test errors LinearPixels {lp_error}%, RandomCifar "
                             f"{rc['test_error']}% are not well under chance")
    log(json.dumps({
        "main_path": "LinearPixels and RandomCifar", "card": card,
        "train_images": N_TRAIN, "test_images": N_TEST,
        "linear_pixels": {"train_accuracy": lp["train_accuracy"],
                          "test_accuracy": lp["test_accuracy"], "test_error": lp_error,
                          "seconds": lp["seconds"]},
        "random_cifar": {k: rc[k] for k in ("train_error", "test_error", "seconds",
                                            "featurize_seconds", "featurize_images_per_sec",
                                            "solve_seconds")},
        "conv_rect_pool_launches": rc_fused, "rect_pool_launches": rc_unfused,
    }))

    # One production chunk of RandomCifar's Convolver terms through the entry.
    featurizer = rc["servable"].nodes[0]
    conv = featurizer.conv
    images = cifar_loader(str(test_path)).images[:2048]
    terms = (*conv.terms(torch.from_numpy(np.ascontiguousarray(images)).cuda()),
             conv.fsum, conv.filter_means_dot)
    kw = dict(pool_stride=featurizer.pool_stride, pool_size=featurizer.pool_size,
              alpha=featurizer.alpha, activation_dtype=torch.float32)
    got = rp.conv_rect_pool(*terms, **kw)
    ref = rp.conv_rect_pool_reference(*terms, **kw)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    # Both sides compute the same f32 activations and sum them in another
    # order: 1e-5 * max.
    if not err <= 1e-5 * scale:
        raise AssertionError(f"conv_rect_pool f32 on RandomCifar terms: {err} > 1e-5 * {scale}")
    rec = {"shape": list(terms[0].shape), "dtype": "float32", "max_abs_err": err,
           "max_abs": scale,
           "ms": cuda_ms(lambda: rp.conv_rect_pool(*terms, **kw)),
           "plain_ms": cuda_ms(lambda: rp.conv_rect_pool_reference(*terms, **kw)),
           "launches": rc_fused}
    rec["bound_ms"], rec["bound_by"] = conv_rect_pool_bound(terms, got.numel())
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    log(f"conv_rect_pool on a RandomCifar chunk {rec}")
    return rec


def run_newsgroups(card: str, root: Path) -> dict:
    """Phase 15: NewsgroupsPipeline at BASELINE config 2 through the CLI on
    a synthetic tree of half the 20news-bydate split's size (written under
    ``root``), then naive-Bayes scores card against CPU and at served
    batches.  No hand kernel may launch in it."""
    before = kernel_launches()
    rng = np.random.default_rng(17)
    t = time.perf_counter()
    tokens = 0
    for split, total in (("train", NG_TRAIN), ("test", NG_TEST)):
        per_class = [total // 20 + (c < total % 20) for c in range(20)]
        tokens += write_newsgroups_tree(root / split, NG_CLASSES, per_class, rng)
    write_secs = time.perf_counter() - t
    t = time.perf_counter()
    test = newsgroups_loader(str(root / "test"))
    load_secs = time.perf_counter() - t
    res = newsgroups.main(["--trainLocation", str(root / "train"),
                           "--testLocation", str(root / "test"), *NG_FLAGS])
    if not res["test_error"] < 20.0:  # chance is 95%
        raise AssertionError(f"Newsgroups test error {res['test_error']}% is not below 20%")
    if res["num_features"] != 100_000:
        raise AssertionError(f"Newsgroups kept {res['num_features']} features, not 100,000")
    log(json.dumps({
        "main_path": "NewsgroupsPipeline BASELINE config 2 (--nGrams 2 --commonFeatures 100000)",
        "card": card, "train_docs": NG_TRAIN, "test_docs": NG_TEST, "tokens": tokens,
        "write_seconds": write_secs, "test_load_seconds": load_secs,
        **{k: res[k] for k in ("test_error", "seconds", "text_seconds", "score_seconds",
                               "num_features", "test_nnz")},
    }))

    # Served batches reproduce the offline scores bit for bit; then the same
    # fitted state scores on the CPU.
    nodes = res["servable"].nodes  # the text nodes, vectorizer, model, argmax
    vectorizer, model = nodes[-3:-1]
    score = Pipeline(nodes[:-1])
    docs = test.data[:NG_CARD_VS_CPU_DOCS]
    offline = res["test_scores"]
    for chunk in (1, 4, 16, 64):
        served = np.concatenate([score(docs[i : i + chunk]).cpu().numpy()
                                 for i in range(0, 64, chunk)])
        if not np.array_equal(served, offline[:64]):
            raise AssertionError(f"Newsgroups scores at batch {chunk} differ from offline")
    csr = Pipeline(nodes[:-2])(docs)
    on_cpu = convert.newsgroups_from_arrays(
        vocabulary=list(vectorizer.feature_space), pi=model.pi.cpu().numpy(),
        theta=model.theta.cpu().numpy(), device="cpu",
    ).model(csr).numpy()
    on_card = offline[: len(docs)]
    err = np.abs(on_card - on_cpu).max()
    scale = np.abs(on_cpu).max()
    differ = int((on_card.argmax(axis=1) != on_cpu.argmax(axis=1)).sum())
    log(f"Newsgroups card vs cpu on {len(docs)} documents: scores max abs err {err:.4e} of max "
        f"{scale:.4e} (bound 1e-5·max), {differ} predictions differ (bound 0)")
    if not (err <= 1e-5 * scale and differ == 0):
        raise AssertionError("Newsgroups card and CPU disagree beyond the bounds")
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"hand kernels launched in the Newsgroups phase: {before} -> {after}")
    log(f"Newsgroups phase: kernel launch counters unchanged {after}")


def imagenet_class_params(num_classes: int = IMAGENET_CLASSES) -> tuple:
    """Each class's colour, grating orientation, grating period and grating
    channel.  The colours are distinct points of a 10x10x10 grid over
    [40, 215] (seeded order), so LCS's local colour statistics carry the
    class; the 96 gratings (8 orientations, 4 periods, 3 channels) carry it
    in SIFT's gradients too."""
    levels = np.linspace(40.0, 215.0, 10)
    grid = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    palette = grid[np.random.default_rng(1).permutation(len(grid))[:num_classes]]
    c = np.arange(num_classes)
    angles = np.pi * (c % 8) / 8
    periods = np.array([5.0, 7.0, 10.0, 14.0])[(c // 8) % 4]
    return palette, angles, periods, (c // 32) % 3


def imagenet_images(seed: int, labels: np.ndarray, shapes: list) -> list:
    """Seeded synthetic BGR images in [0, 255], integer-valued, made on the
    card: the class colour jittered by up to 3 levels, pixel noise of
    spread 12, and the class grating (amplitude 40-60, random phase) in the
    class channel.  Returns one f32 [H, W, 3] host array per label."""
    palette, angles, periods, channels = imagenet_class_params()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = [None] * len(labels)
    for shape in sorted(set(shapes)):
        idx = np.array([i for i, s in enumerate(shapes) if s == shape])
        h, w = shape
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device="cuda"),
                                torch.arange(w, dtype=torch.float32, device="cuda"),
                                indexing="ij")
        for i in range(0, len(idx), 64):
            part = idx[i : i + 64]
            c = labels[part]
            b = len(part)

            def t(a):
                return torch.as_tensor(a, dtype=torch.float32, device="cuda")

            base = t(palette[c]) + 6.0 * torch.rand((b, 3), generator=gen, device="cuda") - 3.0
            phase = 2 * np.pi * torch.rand((b, 1, 1), generator=gen, device="cuda")
            amp = 40.0 + 20.0 * torch.rand((b, 1, 1), generator=gen, device="cuda")
            a, period = t(angles[c])[:, None, None], t(periods[c])[:, None, None]
            wave = amp * torch.sin((xx * torch.cos(a) + yy * torch.sin(a)) * (2 * np.pi / period)
                                   + phase)
            img = base[:, None, None, :] + 12.0 * torch.randn((b, h, w, 3), generator=gen,
                                                              device="cuda")
            img[torch.arange(b, device="cuda"), :, :, t(channels[c]).long()] += wave
            host = img.clamp_(0, 255).round_().cpu().numpy()
            for j, k in enumerate(part):
                out[k] = host[j]
    return out


def imagenet_split(seed: int, per_class: int) -> LabeledImages:
    """``per_class`` images of each of the 1,000 classes, alternating
    between the two image sizes, in a seeded random order."""
    labels = np.repeat(np.arange(IMAGENET_CLASSES), per_class)
    shapes = [IMAGENET_SHAPES[i % 2] for i in range(len(labels))]
    images = imagenet_images(seed, labels, shapes)
    order = np.random.default_rng(seed).permutation(len(labels))
    return LabeledImages([images[i] for i in order], labels[order].astype(np.int32),
                         [f"synthetic/{i:07d}" for i in range(len(labels))])


def imagenet_peak_lower_bound(train: LabeledImages, conf) -> float:
    """GB the fit holds at once in the SIFT branch's PCA fit: the raw SIFT
    training descriptors (f32, 128 each) and the column sample three times
    over (the sample, its centred copy and the QR factorisation's copy of
    it).  A lower bound of the peak: the QR factorisation's workspace and
    what the process held before the run come on top and are not reckoned.
    The projected descriptors replace the raw ones bucket by bucket, and the
    test split is featurized 32 images at a time, so neither raises it."""
    sift = SIFTExtractor(scale_step=conf.sift_scale_step)
    cols = sum(sift.num_descriptors(*img.shape[:2]) for img in train.images)
    return (cols + 3 * min(cols, conf.num_pca_samples)) * 128 * 4 / 1e9


class BranchLaunches:
    """Counts the fv_stats launches of each descriptor branch while it is
    active (it wraps ``imagenet_sift_lcs_fv.branch_features``)."""

    def __enter__(self) -> dict:
        self.counts = {b: 0 for b in inet.BRANCHES}
        self._orig = inet.branch_features

        def counted(conf, train_images, test_images, branch, *rest):
            before = fs.launches
            try:
                return self._orig(conf, train_images, test_images, branch, *rest)
            finally:
                self.counts[branch] += fs.launches - before

        inet.branch_features = counted
        return self.counts

    def __exit__(self, *exc) -> None:
        inet.branch_features = self._orig


def imagenet_record(res: dict) -> dict:
    """The run's errors and stage seconds; raises unless the model is
    finite and the top-5 error is below 50 % (chance 99.5 %)."""
    model = res["bundle"]["model"]
    if not all(bool(torch.isfinite(t).all()) for t in [*model.xs, model.b]):
        raise AssertionError("ImageNetSiftLcsFV model is not finite")
    if not res["top5_err_percent"] < 50.0:
        raise AssertionError(f"ImageNetSiftLcsFV top-5 error {res['top5_err_percent']}% "
                             "is not below 50%")
    return {k: res[k] for k in ("top5_err_percent", "top1_err_percent", "seconds",
                                "sift_branch_seconds", "lcs_branch_seconds", "solve_seconds",
                                "eval_seconds", "featurize_images_per_sec",
                                "branch_stage_seconds")}


def run_imagenet(card: str, stem: Path) -> tuple:
    """Phases 17 and 18: ImageNetSiftLcsFV in memory at full width (its
    fitted bundle saved at ``stem``), its fitted branches applied to served
    batches, then card against CPU.  Returns the fv_stats launches of the
    path (fit, eval and served batches), the two splits, and what phase
    27(d) restores against: the stem, the run's test scores, top-5 error
    and seconds."""
    t = time.perf_counter()
    train = imagenet_split(19, IMAGENET_TRAIN_PER_CLASS)
    test = imagenet_split(23, IMAGENET_TEST_PER_CLASS)
    data_secs = time.perf_counter() - t
    conf = inet.ImageNetSiftLcsFVConfig(num_classes=IMAGENET_CLASSES, device="cuda",
                                        pipeline_file=str(stem))
    bound_gb = imagenet_peak_lower_bound(train, conf)
    log(f"ImageNet data: {len(train)} train / {len(test)} test images in {data_secs:.1f} s; "
        f"reckoned peak at least {bound_gb:.2f} GB (raw SIFT descriptors and the PCA sample "
        "three times over; the QR workspace not reckoned)")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fs.launches = 0
    with BranchLaunches() as by_branch:
        res = inet.run(conf, train, test)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fit_launches = fs.launches
    rec = imagenet_record(res)
    if not all(by_branch[b] > 0 for b in inet.BRANCHES):
        raise AssertionError(f"fv_stats launches by branch {by_branch}")
    if not bound_gb <= peak_gb < 80.0:
        raise AssertionError(f"ImageNetSiftLcsFV peaked at {peak_gb} GB (reckoned at least "
                             f"{bound_gb} GB)")

    # The fitted branches on new images: batches of 1, 4 and 16 test images
    # of one size reproduce the offline scores.
    fitted = convert.FittedImageNet(res["bundle"], conf)
    land = [i for i, img in enumerate(test.images) if img.shape[:2] == IMAGENET_SHAPES[0]][:16]
    offline = res["test_scores"][land]
    for chunk in (1, 4, 16):
        served = np.concatenate([
            fitted.scores([test.images[j] for j in land[i : i + chunk]]).cpu().numpy()
            for i in range(0, len(land), chunk)
        ])
        err = np.abs(served - offline).max()
        if not err <= 1e-4 * np.abs(offline).max():
            raise AssertionError(f"ImageNet scores at batch {chunk} differ from the offline "
                                 f"scores by {err} (max {np.abs(offline).max()})")
    main_launches = fs.launches
    log(json.dumps({
        "main_path": "ImageNetSiftLcsFV BASELINE config 5 (in memory)", "card": card,
        "classes": IMAGENET_CLASSES, "train_images": len(train), "test_images": len(test),
        "feature_dim": 2 * 2 * conf.desc_dim * conf.vocab_size, "data_seconds": data_secs,
        **rec, "peak_memory_gb": peak_gb, "peak_lower_bound_gb": bound_gb,
        "fv_stats_launches_fit": fit_launches, "fv_stats_launches_by_branch": by_branch,
        "fv_stats_launches_serve": main_launches - fit_launches,
    }))
    arrays = convert.imagenet_to_arrays(res["bundle"], conf)
    saved = {"stem": stem, "scores": res["test_scores"], "seconds": res["seconds"],
             "top5_err_percent": res["top5_err_percent"],
             "top1_err_percent": res["top1_err_percent"]}
    del res, fitted
    torch.cuda.empty_cache()
    imagenet_card_vs_cpu(arrays, [test.images[j] for j in land[:4]])
    return main_launches, train, test, saved


def imagenet_card_vs_cpu(arrays: dict, images: list) -> dict:
    """Phase 18: one fitted state on the card and on the CPU; four images
    through both branches on both.  Bars: quantised SIFT descriptors (scale
    step 1, bf16) within +-1 on >= 99.5 % of entries and LCS descriptors
    ``torch.equal`` (the same f32 multiplies and adds run on both devices,
    and the roots are correctly rounded by ``sqrt_rn``); from
    identical descriptors, the Fisher statistics within rtol 2e-4, atol
    2e-5·max, and the features and scores no further from their f64
    evaluation on the card than on the CPU plus 1e-3·max (phase 7's bars)."""
    fitted = {dev: convert.imagenet_from_arrays(**arrays, device=dev) for dev in ("cuda", "cpu")}
    conf = fitted["cpu"].conf
    x = torch.from_numpy(np.stack(images))
    sift = SIFTExtractor(scale_step=conf.sift_scale_step, compute_dtype=torch.bfloat16)
    sift_cpu = sift(grayscale(x))
    sift_within = (sift(grayscale(x.cuda())).cpu() - sift_cpu).abs().le(1.0).float().mean().item()
    lcs = LCSExtractor(conf.lcs_stride, conf.lcs_border, conf.lcs_patch)
    lcs_cpu = lcs(x)
    lcs_card = lcs(x.cuda()).cpu()
    lcs_err = (lcs_card - lcs_cpu).abs().max().item()
    if not sift_within >= 0.995:
        raise AssertionError(f"SIFT descriptors card vs cpu within +-1: {sift_within}")
    if not torch.equal(lcs_card, lcs_cpu):
        raise AssertionError(f"LCS descriptors card vs cpu differ by {lcs_err}")

    descs = {"sift": SignedHellingerMapper()(sift_cpu), "lcs": lcs_cpu}
    feats = {"cuda": [], "cpu": []}
    exact, stat_errs = [], {}
    for b in inet.BRANCHES:
        pca_desc, gmm = {}, {}
        for dev in fitted:
            pca_desc[dev] = fitted[dev].bundle[f"{b}_pca"](descs[b].to(dev))
            gmm[dev] = fitted[dev].bundle[f"{b}_gmm"]
        stats = {dev: [t.cpu() for t in fs.fv_stats(pca_desc[dev], None, gmm[dev].means,
                                                    gmm[dev].variances, gmm[dev].weights)]
                 for dev in fitted}
        for card_stat, cpu_stat in zip(stats["cuda"], stats["cpu"]):
            torch.testing.assert_close(card_stat, cpu_stat, rtol=2e-4,
                                       atol=2e-5 * cpu_stat.abs().max().item())
        stat_errs[b] = [rel_err(a, c) for a, c in zip(stats["cuda"], stats["cpu"])]
        for dev in fitted:
            feats[dev].append(fisher_feature_pipeline(gmm[dev])(pca_desc[dev]).cpu())
        g64 = GaussianMixtureModel(*(t.double() for t in (gmm["cpu"].means, gmm["cpu"].variances,
                                                          gmm["cpu"].weights)))
        exact.append(fisher_feature_pipeline(g64)(pca_desc["cpu"].double()))
    exact_feats = torch.cat(exact, dim=1)
    model = fitted["cpu"].bundle["model"]
    model64 = BlockLinearMapper([m.double() for m in model.xs], model.block_size, model.b.double())
    exact_scores = model64(exact_feats)
    errs = {}
    for dev in fitted:
        f = torch.cat(feats[dev], dim=1)
        s = fitted[dev].bundle["model"](f.to(dev)).cpu()
        errs[dev] = (((f.double() - exact_feats).abs().max() / exact_feats.abs().max()).item(),
                     ((s.double() - exact_scores).abs().max() / exact_scores.abs().max()).item())
    rec = {"sift_within_1": sift_within, "lcs_max_abs_err": lcs_err,
           "lcs_equal": bool(torch.equal(lcs_card, lcs_cpu)),
           "fv_stats_rel_err": stat_errs,
           "features_rel_err_from_f64": {d: e[0] for d, e in errs.items()},
           "scores_rel_err_from_f64": {d: e[1] for d, e in errs.items()}}
    log(f"ImageNet card vs cpu on {len(images)} images: {json.dumps(rec)}")
    for i, what in enumerate(("features", "scores")):
        if not errs["cuda"][i] <= errs["cpu"][i] + 1e-3:
            raise AssertionError(f"card {what} {errs['cuda'][i]} further from f64 than the "
                                 f"cpu's {errs['cpu'][i]}")
    return rec


def synset(c: int) -> str:
    return f"n{c:08d}"


def write_imagenet_tars(root: Path, splits: dict) -> None:
    """Encode each split's images as baseline JPEGs (q90, 4:2:0) into
    ``root/<split>/<synset>.tar``, one tar per class with members
    ``<synset>/<split>_<i>.JPEG``, and write ``root/labels.txt``, one
    ``synset class-id`` line per class."""
    (root / "labels.txt").write_text(
        "".join(f"{synset(c)} {c}\n" for c in range(IMAGENET_CLASSES)))
    with ThreadPoolExecutor(8) as pool:
        for split, data in splits.items():
            (root / split).mkdir()
            encoded = list(pool.map(lambda img: encode_jpeg(img, 90, "4:2:0")[0], data.images))
            by_class: dict = {}
            for i, (jpeg, c) in enumerate(zip(encoded, data.labels)):
                by_class.setdefault(int(c), []).append((i, jpeg))
            for c, members in by_class.items():
                with tarfile.open(root / split / f"{synset(c)}.tar", "w") as tf:
                    for i, jpeg in members:
                        info = tarfile.TarInfo(f"{synset(c)}/{split}_{i:06d}.JPEG")
                        info.size = len(jpeg)
                        tf.addfile(info, io.BytesIO(jpeg))


def run_imagenet_tar(card: str, train: LabeledImages, test: LabeledImages) -> tuple[int, int]:
    """Phase 19: ImageNetSiftLcsFV from JPEG tars through ``--streamIngest
    --deviceDecode``, on one training image per class and the first 500
    test images of phase 17, then in memory on the same pixel arrays.
    Returns the decode and fv_stats launches of the tar path."""
    first: dict = {}
    for i, c in enumerate(train.labels):
        first.setdefault(int(c), i)
    keep = sorted(first.values())
    sub_train = LabeledImages([train.images[i] for i in keep], train.labels[keep],
                              [train.filenames[i] for i in keep])
    sub_test = LabeledImages(test.images[:IMAGENET_TAR_TEST], test.labels[:IMAGENET_TAR_TEST],
                             test.filenames[:IMAGENET_TAR_TEST])
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        write_imagenet_tars(root, {"train": sub_train, "test": sub_test})
        encode_secs = time.perf_counter() - t
        tar_bytes = sum(p.stat().st_size for p in root.glob("*/*.tar"))
        log(f"ImageNet JPEG tars: {len(sub_train)} + {len(sub_test)} images encoded in "
            f"{encode_secs:.1f} s")
        resilience.counters.reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        jd.launches = jd.decode_launches = fs.launches = 0
        with BranchLaunches() as by_branch:
            res = inet.main([
                "--trainLocation", str(root / "train"), "--testLocation", str(root / "test"),
                "--labelPath", str(root / "labels.txt"), "--streamIngest", "--deviceDecode",
                "--numClasses", str(IMAGENET_CLASSES), "--device", "cuda",
            ])
        decode_launches, fv_launches, idct_launches = jd.decode_launches, fs.launches, jd.launches
        peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The native entropy pass ran with nothing skipped or routed away, and
    # every pass over a split saw the same survivors (the source checks
    # their names; here their counts).
    chunks = 0
    for split, passes in res["ingest"].items():
        want = len(sub_train) if split == "train" else len(sub_test)
        if len(passes) != 2 or any(p["decoded"] != want for p in passes):
            raise AssertionError(f"{split}: passes {passes}")
        for st in passes:
            if st["entropy_backend"] != "native":
                raise AssertionError(f"{split}: entropy backend {st['entropy_backend']!r}")
            if st["skipped"] or st["device_fallbacks"] or st["entropy_corrupt"]:
                raise AssertionError(f"{split}: skips or fallbacks in the stream: {st}")
            chunks += st["batches"]
    if resilience.counters.snapshot():
        raise AssertionError(f"counted events: {resilience.counters.snapshot()}")
    # The fused decode ran (two launches a chunk), the IDCT entry never did,
    # and the statistics kernel ran in both branches.
    if not (decode_launches >= 2 * chunks and idct_launches == 0
            and all(by_branch[b] > 0 for b in inet.BRANCHES)):
        raise AssertionError(f"launches: decode {decode_launches}, idct {idct_launches}, "
                             f"fv_stats by branch {by_branch}, {chunks} chunks")
    rec = imagenet_record(res)
    del res
    torch.cuda.empty_cache()
    memory = inet.run(inet.ImageNetSiftLcsFVConfig(num_classes=IMAGENET_CLASSES, device="cuda"), sub_train, sub_test)
    if not abs(rec["top5_err_percent"] - memory["top5_err_percent"]) <= 2.0:
        raise AssertionError(f"top-5 error from JPEG tars {rec['top5_err_percent']}% vs "
                             f"{memory['top5_err_percent']}% in memory on the same pixels")
    log(json.dumps({
        "main_path": "ImageNetSiftLcsFV from JPEG tars, --streamIngest --deviceDecode",
        "card": card, "train_images": len(sub_train), "test_images": len(sub_test),
        **rec, "top5_err_percent_in_memory": memory["top5_err_percent"],
        "top1_err_percent_in_memory": memory["top1_err_percent"],
        "peak_memory_gb": peak_gb, "encode_seconds": encode_secs,
        "tar_bytes_per_image": tar_bytes / (len(sub_train) + len(sub_test)),
        "chunks": chunks, "decode_launches": decode_launches, "idct_launches": idct_launches,
        "fv_stats_launches": fv_launches, "fv_stats_launches_by_branch": by_branch,
    }))
    return decode_launches, fv_launches

def cifar48_split(n: int, rng, palette) -> LabeledImageBatch:
    """``n`` separable 48 px images of phase 3's recipe (a class colour of
    the shared ``palette`` plus noise, a class-frequency wave in one
    channel), as f32 [n, 48, 48, 3] of whole levels in [0, 255]."""
    xx = np.arange(CIFAR_TAR_PX, dtype=np.float64)[None, None, :]
    images = np.empty((n, CIFAR_TAR_PX, CIFAR_TAR_PX, 3), np.float32)
    labels = rng.integers(0, N_CLASSES, n)
    for i in range(0, n, 5000):
        lab = labels[i : i + 5000]
        m = len(lab)
        img = palette[lab][:, :, None, None] + rng.normal(0, 25, (m, 3, CIFAR_TAR_PX, CIFAR_TAR_PX))
        img[np.arange(m), lab % 3] += 30 * np.sin(xx / (2.0 + lab[:, None, None]))
        images[i : i + m] = np.clip(img, 0, 255).astype(np.uint8).transpose(0, 2, 3, 1)
    return LabeledImageBatch(images, labels.astype(np.int32))


def write_cifar_tar(path: Path, split: LabeledImageBatch) -> dict:
    """Encode ``split`` as baseline JPEGs (q90, 4:2:0) into one tar of
    ``<label>/img_NNNNN.jpg`` members.  Returns member name -> JPEG bytes.
    A 48 px image is too small for the encoder's numpy calls to leave the
    interpreter lock, so the encode runs in 8 spawned processes."""
    members = {}
    encode = functools.partial(encode_jpeg, quality=90, subsampling="4:2:0")
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as pool:
        encoded = pool.map(encode, split.images, chunksize=256)
        with tarfile.open(path, "w") as tf:
            for i, ((jpeg, _coeffs), label) in enumerate(zip(encoded, split.labels)):
                name = f"{int(label)}/img_{i:05d}.jpg"
                info = tarfile.TarInfo(name)
                info.size = len(jpeg)
                tf.addfile(info, io.BytesIO(jpeg))
                members[name] = jpeg
    return members


def decode_members_on_card(members: dict, names: list) -> np.ndarray:
    """The JPEGs ``names`` decoded in memory, in that order: the native
    entropy pass on the host, then ``decode_batch`` on the card a chunk of
    one geometry at a time."""
    with ThreadPoolExecutor(8) as pool:
        images = list(pool.map(lambda n: jd.entropy_decode(members[n], backend="native"), names))
    out = []
    for i in range(0, len(images), 2048):
        chunk = images[i : i + 2048]
        if len({im.geom for im in chunk}) != 1:
            raise AssertionError("the tar's JPEGs do not share one geometry")
        coeffs, qt = jd.stack_coeff_images(chunk)
        out.append(jd.decode_batch(chunk[0].geom, coeffs, qt, "cuda").cpu().numpy())
    return np.concatenate(out)


def load_trace_view():
    """``tools/trace_view.py`` of this checkout, loaded by path (the port
    itself imports nothing from ``tools/``)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_view", Path(__file__).resolve().parent / "tools" / "trace_view.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_cifar_tar(card: str, train_path: Path, test_path: Path, data_dir: Path) -> tuple:
    """Phase 22: RandomPatchCifar at its defaults with the test split
    streamed from a JPEG tar with device decode (K3 then K1), traced.
    Returns the path's launches, and what phase 24 reuses: the tar (kept in
    ``data_dir``), the training split, the run's config and predictions."""
    rng = np.random.default_rng(22)
    palette = rng.uniform(40, 215, (N_CLASSES, 3))
    conf = cifar.RandomCifarConfig(
        num_filters=100, patch_size=6, pool_size=14, pool_stride=13, alpha=0.25, lam=10.0,
        whitener_size=100000, device="cuda", device_decode=True)
    trace_view = load_trace_view()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        test = cifar48_split(CIFAR_TAR_TEST, rng, palette)
        tar = data_dir / "cifar48_test.tar"
        members = write_cifar_tar(tar, test)
        encode_secs = time.perf_counter() - t
        log(f"Cifar JPEG tar: {CIFAR_TAR_TEST} images of {CIFAR_TAR_PX} px encoded in "
            f"{encode_secs:.1f} s, {tar.stat().st_size / CIFAR_TAR_TEST:.0f} bytes each")

        trace_path = root / "cifar_tar_trace.json"
        trace.disable()
        trace.reset()
        trace.enable(str(trace_path))
        resilience.counters.reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with stage_timer("load"):
            train = cifar48_split(N_TRAIN, rng, palette)
        rp.launches = rp.fused_launches = jd.launches = jd.decode_launches = fs.launches = 0
        res = cifar.run(dataclasses.replace(conf, stream_test_tar=str(tar)), train,
                        LabeledImageBatch(train.images[:0], train.labels[:0]))
        launches = {"conv_rect_pool": rp.fused_launches, "rect_pool": rp.launches,
                    "decode_pixels": jd.decode_launches, "idct_blocks": jd.launches,
                    "fv_stats": fs.launches}
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        trace.flush()
        trace.disable()
        events = trace_view.load_events(str(trace_path))
        trace.reset()

        # The same pixels in memory: the members decoded by decode_batch on
        # the card, in the stream's order, through a run without the stream.
        t = time.perf_counter()
        names = res["test_filenames"]
        pixels = decode_members_on_card(members, names)
        mem = cifar.run(dataclasses.replace(conf, device_decode=False), train,
                        LabeledImageBatch(pixels, np.asarray(res["test_labels"], np.int32)))
        memory_secs = time.perf_counter() - t

    st = res["ingest"]
    chunks = st["batches"]
    train_chunks = math.ceil(N_TRAIN / conf.featurize_chunk)
    if st["entropy_backend"] != "native" or st["decoded"] != CIFAR_TAR_TEST:
        raise AssertionError(f"stream stats {st}")
    if st["skipped"] or st["device_fallbacks"] or st["entropy_corrupt"]:
        raise AssertionError(f"skips or fallbacks in the stream: {st}")
    if not (launches["decode_pixels"] >= 2 * chunks and launches["idct_blocks"] == 0
            and launches["conv_rect_pool"] >= chunks + train_chunks
            and launches["rect_pool"] == 0):
        raise AssertionError(f"launches {launches} for {chunks} test and {train_chunks} "
                             "train chunks")
    if resilience.counters.snapshot():
        raise AssertionError(f"counted faults: {resilience.counters.snapshot()}")
    if not res["test_error"] < 45.0:  # chance is 90%
        raise AssertionError(f"test error {res['test_error']}% is not well under chance")
    agree = float(np.mean(mem["test_predictions"] == res["test_predictions"]))
    stages = trace_view.per_stage(events)
    overlap = trace_view.overlap_from_spans(events)
    rec = {
        "phase": "RandomPatchCifar, test split from a JPEG tar (--streamTestTar --deviceDecode)",
        "card": card, "train_images": N_TRAIN, "test_images": CIFAR_TAR_TEST,
        "image_px": CIFAR_TAR_PX, "encode_seconds": encode_secs,
        **{k: res[k] for k in ("train_error", "test_error", "seconds", "learn_seconds",
                               "featurize_seconds", "featurize_images_per_sec",
                               "solve_seconds")},
        "test_chunks": chunks, "launches": launches, "peak_memory_gb": peak_gb,
        "in_memory_test_error": mem["test_error"], "in_memory_seconds": memory_secs,
        "predictions_equal_in_memory": agree == 1.0, "prediction_agreement": agree,
        "stage_totals_ms": {k: v["total_ms"] for k, v in stages.items()
                            if k in TAR_STAGES or k.startswith("ingest.")},
        "decode_consume_overlap": overlap, "trace_events": len(events),
    }
    log(json.dumps(rec))
    if agree != 1.0:
        raise AssertionError(f"streamed predictions agree with the in-memory run on the same "
                             f"pixels on {agree:.6f} of the test images, not all")
    names_seen = {e["name"] for e in trace_view.spans(events)}
    missing = (set(TAR_STAGES) | set(TAR_INGEST_SPANS)) - names_seen
    if missing:
        raise AssertionError(f"the trace lacks spans {sorted(missing)}")
    if not overlap or overlap["decode_spans"] != CIFAR_TAR_TEST:
        raise AssertionError(f"decode/consume overlap {overlap}")

    # What tracing costs: phase 3's fit with --trace, then without.
    rates = {}
    for traced in (True, False):
        flags = ["--trace", str(train_path.parent / "phase3_trace.json")] if traced else []
        again = cifar.main(["--trainLocation", str(train_path), "--testLocation",
                            str(test_path), *MAIN_FLAGS, *flags])
        trace.disable()
        trace.reset()
        rates["traced" if traced else "untraced"] = again["featurize_images_per_sec"]
    log(json.dumps({"phase": "tracing cost on phase 3's fit", "card": card,
                    "featurize_images_per_sec": rates}))
    return launches, {"tar": tar, "train": train, "conf": conf,
                      "predictions": res["test_predictions"]}


def run_descriptors(card: str) -> None:
    """Phase 20: HOG and DAISY on the card at VOC's two shapes, each checked
    for shape, finiteness, run-to-run bits and against the CPU, and timed.
    No hand kernel may launch."""
    before = kernel_launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    voc = voc_images(np.random.default_rng(20), {shape: DESC_BATCH for shape in VOC_SHAPES})
    nodes = {"hog": HogExtractor(HOG_BIN), "daisy": DaisyExtractor()}
    rec = {}
    for shape, rows in DESC_ROWS.items():
        batch = torch.from_numpy(np.stack([im for im in voc.images if im.shape[:2] == shape]))
        batch = batch.cuda()
        inputs = {"hog": batch.flip(-1) / 255.0, "daisy": grayscale(batch)}  # RGB; gray
        for (name, node), n_rows in zip(nodes.items(), rows):
            x = inputs[name]
            out = node(x)
            if out.shape != (DESC_BATCH, n_rows, 32 if name == "hog" else 200):
                raise AssertionError(f"{name} at {shape}: output shape {tuple(out.shape)}")
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name} at {shape}: non-finite output")
            if not torch.equal(node(x), out):
                raise AssertionError(f"{name} at {shape}: two card runs differ")
            on_cpu = node(x[:DESC_CARD_VS_CPU].cpu())
            err = (out[:DESC_CARD_VS_CPU].cpu() - on_cpu).abs().max().item()
            if not torch.equal(out[:DESC_CARD_VS_CPU].cpu(), on_cpu):
                raise AssertionError(f"{name} at {shape}: card and CPU differ by {err}")
            ms = cuda_ms(lambda: node(x), reps=10, warmup=1)
            rec[f"{name} {shape[0]}x{shape[1]}"] = {
                "rows": n_rows, "ms": ms, "images_per_sec": DESC_BATCH / (ms / 1e3),
                "card_vs_cpu_max_abs_err": err,
            }
            del out, on_cpu
        del batch, inputs
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    after = kernel_launches()
    if after != before:
        raise AssertionError(f"hand kernels launched in the HOG/DAISY phase: {before} -> {after}")
    log(json.dumps({"phase": f"HOG (bin 8) and DAISY (defaults) at VOC shapes, batch {DESC_BATCH}",
                    "card": card, **rec, "peak_memory_gb": peak_gb,
                    "kernel_launches": after}))


def run_text(card: str) -> None:
    """Phase 21: StupidBackoffPipeline through its CLI and CoreNLP on the
    host.  Nothing may be allocated on the card, and no kernel counter may
    move."""
    before = kernel_launches()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        root = Path(tmp)
        t = time.perf_counter()
        tokens = write_newsgroups_tree(root / "docs", NG_CLASSES,
                                       [LM_DOCS_PER_CLASS] * len(NG_CLASSES),
                                       np.random.default_rng(21))
        docs = [p.read_text().strip()
                for c in NG_CLASSES for p in sorted((root / "docs" / c).iterdir())]
        (root / "lines.txt").write_text("\n".join(docs) + "\n")
        write_secs = time.perf_counter() - t
        res = stupid_backoff.main(["--trainData", str(root / "lines.txt"), *LM_FLAGS])
    if not (res["sharded_scoring_equal"] and res["num_tokens"] == tokens):
        raise AssertionError(f"StupidBackoff counted {res['num_tokens']} tokens of {tokens}")
    if sorted(res["shard_sizes"]) != list(range(16)):
        raise AssertionError(f"StupidBackoff shards {sorted(res['shard_sizes'])}")
    t = time.perf_counter()
    grams = CoreNLPFeatureExtractor((1, 2, 3))(docs[:CORENLP_DOCS])
    corenlp_secs = time.perf_counter() - t
    if len(grams) != CORENLP_DOCS or not all(grams):
        raise AssertionError("CoreNLP returned an empty document")
    after = kernel_launches()
    if after != before or torch.cuda.max_memory_allocated() != held:
        raise AssertionError("the host text phase touched the card")
    rec = {
        "docs": len(docs), "write_seconds": write_secs,
        **{k: res[k] for k in ("num_tokens", "vocab_size", "num_ngrams", "seconds")},
        "shard_size_min": min(res["shard_sizes"].values()),
        "shard_size_max": max(res["shard_sizes"].values()),
        "corenlp_docs": CORENLP_DOCS, "corenlp_ngrams": sum(map(len, grams)),
        "corenlp_seconds": corenlp_secs,
    }
    log(json.dumps({"phase": "StupidBackoffPipeline (--numParts 16 --n 3) and CoreNLP (1, 2, 3)",
                    "card": card, **rec, "kernel_launches": after}))


def ledger_row(name: str) -> dict:
    row = kprof.ledger().get(name)
    if row is None:
        raise AssertionError(f"no ledger row {name!r} in {sorted(kprof.ledger())}")
    return {k: row[k] for k in ("runs", "wall_seconds", "flops", "bytes_accessed",
                                "achieved_hbm_gbps", "mfu", "bound", "bound_share")}


def run_restored(card: str, data_dir: Path, fitted: dict) -> dict:
    """Phase 23: the fitted pipelines saved with ``--pipelineFile`` by
    phases 3, 6, 8 and 9, restored: no training data is read and nothing is
    fitted.  Each restored path is driven with the kernel counts set to 0
    just before it and read just after.  Then the same paths once more with
    the profiler on, a capture window around the restored Cifar run, and
    MNIST's config-1 fit for the ``bcd_fit`` plan audit.  Returns the
    restored paths' launches."""
    absent = str(data_dir / "absent")  # no training split exists there
    out: dict = {}

    # (a) RandomPatchCifar: predictions equal to phase 3's, K1 only on the
    # test chunks.
    rp.launches = rp.fused_launches = 0
    res = cifar.main(["--trainLocation", absent, "--testLocation", str(fitted["cifar_test"]),
                      *MAIN_FLAGS, "--pipelineFile", str(fitted["cifar_stem"])])
    out["conv_rect_pool"] = rp.fused_launches
    if not (res["restored"] and np.array_equal(res["test_predictions"], fitted["cifar_pred"])):
        raise AssertionError("restored Cifar predictions differ from phase 3's")
    if out["conv_rect_pool"] != math.ceil(N_TEST / 2048) or rp.launches:
        raise AssertionError(f"restored Cifar launched conv_rect_pool {out['conv_rect_pool']} "
                             f"times (expected {math.ceil(N_TEST / 2048)}), rect_pool {rp.launches}")
    cifar_secs = res["seconds"]

    # (b) MnistRandomFFT: predictions equal to phase 9's, no hand kernel.
    before = kernel_launches()
    mres = mnist.main(["--trainLocation", absent, "--testLocation", str(fitted["mnist"]["test_csv"]),
                       *MNIST_FLAGS, "--pipelineFile", str(fitted["mnist"]["stem"])])
    if not (mres["restored"] and np.array_equal(mres["test_predictions"],
                                                fitted["mnist"]["predictions"])):
        raise AssertionError("restored MNIST predictions differ from phase 9's")
    if kernel_launches() != before:
        raise AssertionError("hand kernels launched in the restored MNIST run")

    # (c) VOCSIFTFisher in memory: phase 6's MAP, through K2.
    conf = voc.SIFTFisherConfig(**VOC_CONF, pipeline_file=str(fitted["voc_stem"]))
    fs.launches = 0
    vres = voc.run(conf, MultiLabeledImages([], [], []), fitted["voc_test"])
    out["fv_stats_in_memory"] = fs.launches
    if not (vres["restored"] and vres["map"] == fitted["voc_map"] and fs.launches >= len(VOC_SHAPES)):
        raise AssertionError(f"restored VOC MAP {vres['map']} (fitted {fitted['voc_map']}), "
                             f"fv_stats {fs.launches} launches")

    # (d) VOCSIFTFisher from the test tar with the decode on the card:
    # phase 8's MAP, through K3 (in the admitted fused_apply) and K2; only
    # the test split streams.
    tars = fitted["voc_tars"]
    tar_flags = ["--trainLocation", absent, "--testLocation", str(tars / "test.tar"),
                 "--labelPath", str(tars / "labels.csv"), *VOC_TAR_FLAGS,
                 "--pipelineFile", str(tars / "bundle")]
    resilience.counters.reset()
    jd.launches = jd.decode_launches = fs.launches = 0
    tres = voc.main(tar_flags)
    out["decode_pixels"], out["fv_stats_jpeg_tars"] = jd.decode_launches, fs.launches
    chunks = tres["ingest"]["test"]["batches"]
    if not (tres["restored"] and tres["map"] == fitted["voc_tar_map"]
            and set(tres["ingest"]) == {"test"}):
        raise AssertionError(f"restored VOC from tars: MAP {tres['map']} (fitted "
                             f"{fitted['voc_tar_map']}), streams {sorted(tres['ingest'])}")
    # The statistics run per shape bucket once the stream ends, in launches
    # of at most 2 GiB of partials (ops/fv_stats.launch_geometry).
    if not (jd.decode_launches >= 2 * chunks and fs.launches >= len(VOC_SHAPES)
            and jd.launches == 0):
        raise AssertionError(f"restored VOC from tars: decode {jd.decode_launches}, fv_stats "
                             f"{fs.launches}, idct {jd.launches} launches for {chunks} chunks")
    if resilience.counters.snapshot():
        raise AssertionError(f"counted events: {resilience.counters.snapshot()}")

    # (e) The same under a 1 MB HBM budget: the decode+featurize is denied
    # once per (transform, geometry), counted, and changes nothing else.
    geometries = len(VOC_SHAPES)
    os.environ["KEYSTONE_HBM_BUDGET"] = "1MB"
    try:
        bres = voc.main(tar_flags)
    finally:
        del os.environ["KEYSTONE_HBM_BUDGET"]
    denied = resilience.counters.get("device_decode_admission_denied")
    if not (denied == geometries and bres["map"] == tres["map"]):
        raise AssertionError(f"under a 1 MB budget: {denied} denials (expected {geometries}), "
                             f"MAP {bres['map']} (unbudgeted {tres['map']})")
    log(json.dumps({
        "phase": "23: restored pipelines (--pipelineFile), no training data read", "card": card,
        "cifar": {"restored_seconds": cifar_secs, "fitted_seconds": fitted["cifar_seconds"],
                  "predictions_equal": True, "conv_rect_pool_launches": out["conv_rect_pool"]},
        "mnist": {"restored_seconds": mres["seconds"], "fitted_seconds": fitted["mnist"]["seconds"],
                  "predictions_equal": True},
        "voc_in_memory": {"restored_seconds": vres["seconds"], "fitted_seconds": fitted["voc_seconds"],
                          "map": vres["map"], "fv_stats_launches": out["fv_stats_in_memory"]},
        "voc_jpeg_tars": {"restored_seconds": tres["seconds"],
                          "fitted_seconds": fitted["voc_tar_seconds"], "map": tres["map"],
                          "decode_pixels_launches": out["decode_pixels"],
                          "fv_stats_launches": out["fv_stats_jpeg_tars"], "chunks": chunks},
        "budget_1mb": {"device_decode_admission_denied": denied, "map": bres["map"],
                       "seconds": bres["seconds"]},
    }))

    # (f) Profiled: the ledger rows of the three kernels on the restored
    # paths, a capture window around the restored Cifar run, and MNIST's
    # config-1 fit for the bcd_fit audit.
    xprof = data_dir / "xprof"
    os.environ[kprof.XPROF_DIR_ENV] = str(xprof)
    os.environ[kprof.XPROF_WINDOW_ENV] = "120"
    try:
        kprof.reset_state()
        with kprof.profiled(True):
            capture = kprof.maybe_capture("chip_smoke", "phase 23: restored Cifar")
            if capture is None:
                raise AssertionError("the capture window did not open")
            cifar.main(["--trainLocation", absent, "--testLocation", str(fitted["cifar_test"]),
                        *MAIN_FLAGS, "--pipelineFile", str(fitted["cifar_stem"])])
            kprof.close_capture()
            voc.main(tar_flags)
            fit = mnist.run(mnist.MnistRandomFFTConfig(**MNIST_CONF), fitted["mnist"]["train"],
                            fitted["mnist"]["test"])
            rows = {name: ledger_row(name) for name in ("conv_rect_pool", "fv_stats",
                                                        "decode_pixels")}
            fused = {k: v for k, v in kprof.ledger().items() if k.startswith("fused_decode:")}
            audits = {"plan": kprof.plan_audits().get("bcd_fit:fused"),
                      "flops": kprof.flops_audits().get("bcd_fit:fused")}
            sampler = kprof.sampler().record()
    finally:
        del os.environ[kprof.XPROF_DIR_ENV], os.environ[kprof.XPROF_WINDOW_ENV]
    trace_path = Path(capture) / kprof.CAPTURE_TRACE_NAME
    text = trace_path.read_text()
    kernel_events = sum(1 for e in json.loads(text).get("traceEvents", [])
                        if e.get("cat") == "kernel")
    if "conv_rect_pool" not in text or audits["plan"] is None:
        raise AssertionError(f"capture names conv_rect_pool: {'conv_rect_pool' in text}; "
                             f"bcd_fit plan audit: {audits['plan']}")
    log(json.dumps({
        "phase": "23: profiled restored paths and the bcd_fit audit", "card": card,
        "ledger": rows, "fused_decode_rows": fused,
        "bcd_fit_report": fit["fit_report"], "bcd_fit_audits": audits,
        "sampler": {k: sampler[k] for k in ("samples", "interval_ms", "crashed", "unavailable")},
        "capture": {"file": str(trace_path), "bytes": trace_path.stat().st_size,
                    "names_conv_rect_pool": True, "cuda_kernel_events": kernel_events,
                    "pool_kernel_named": "pool_kernel" in text},
    }))
    kprof.reset_state()
    return out


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set for the block, restored after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


class StreamedTestPasses:
    """For the block, wraps RandomPatchCifar's streamed test pass
    (``cifar._stream_test_features``, what ``run`` calls): records each
    pass's K1 and K3 launches, seconds (ended by a synchronize) and stream
    stats, and with ``profile_next`` set, traces the next pass in one
    ``torch.profiler`` window into that path."""

    def __init__(self):
        self.passes: list = []
        self.profile_next: Path | None = None

    def __enter__(self):
        self._orig = cifar._stream_test_features
        cifar._stream_test_features = self._pass
        return self

    def __exit__(self, *exc):
        cifar._stream_test_features = self._orig

    def _pass(self, conf, conv_pipe, dev):
        torch.cuda.synchronize()
        k1, k3 = rp.fused_launches, jd.decode_launches
        profile, self.profile_next = self.profile_next, None
        prof = None
        if profile is not None:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                      torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            # A first copy, then a pause, before the pass: the traces of this
            # window have missed the pass's first copies (PERF.md §7).
            torch.ones(16).to(dev)
            torch.cuda.synchronize()
            time.sleep(0.5)
        t = time.perf_counter()
        try:
            out = self._orig(conf, conv_pipe, dev)
            torch.cuda.synchronize()
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(str(profile))
        self.passes.append({"conv_rect_pool": rp.fused_launches - k1,
                            "decode_pixels": jd.decode_launches - k3,
                            "seconds": time.perf_counter() - t,
                            "stats": dataclasses.asdict(out[2])})
        return out


def h2d_from_trace(path: Path) -> dict:
    """The host-to-device copies of one profiled stream pass: the pinned
    copies, their streams and bytes, every other HtoD copy, and the share
    of pinned copy time that a kernel on another stream overlaps."""
    events = json.loads(path.read_text())["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    kernels = sorted((e["ts"], e["ts"] + e["dur"], e["args"].get("stream"))
                     for e in events if e.get("cat") == "kernel")
    pinned = [e for e in copies if "Pinned" in e["name"]]
    other = [e for e in copies if "Pinned" not in e["name"]]
    copy_streams = {e["args"].get("stream") for e in pinned}
    overlap = 0.0
    for c in pinned:
        lo, hi = c["ts"], c["ts"] + c["dur"]
        spans = sorted((max(lo, s), min(hi, e)) for s, e, st in kernels
                       if st not in copy_streams and s < hi and e > lo)
        covered, end = 0.0, lo
        for s, e in spans:
            if e > end:
                covered += e - max(s, end)
                end = e
        overlap += covered
    copy_us = sum(c["dur"] for c in pinned)
    t0 = min((e["ts"] for e in copies + [k for k in events if k.get("cat") == "kernel"]),
             default=0)
    return {
        "htod": [(c["name"].split("(")[-1].rstrip(")"), c["args"].get("bytes"),
                  c["args"].get("stream"), round(c["ts"] - t0)) for c in copies],
        "memcpy_calls": sum(1 for e in events if e.get("cat") == "cuda_runtime"
                            and "Memcpy" in e.get("name", "")),
        "pinned_copies": len(pinned),
        "pinned_bytes": (sum(c["args"]["bytes"] for c in pinned)
                         if all("bytes" in c["args"] for c in pinned) else None),
        "pinned_copy_ms": copy_us / 1e3,
        "copy_streams": sorted(copy_streams, key=str),
        "kernel_streams": sorted({st for _, _, st in kernels}, key=str),
        "other_htod": [(c["name"], c["args"].get("bytes"), c["args"].get("stream"))
                       for c in other],
        "kernels": len(kernels),
        "overlap_share": overlap / copy_us if copy_us else None,
    }


def check_h2d(rep: dict, copies: int, h2d_bytes: int) -> None:
    """Every copy of the stream that the trace holds is pinned, on one
    stream of its own that runs no kernel; what else crossed is the
    consumer's small index vectors.  The trace must hold at least one of
    the stream's ``copies``; how many it holds is reported
    (``pinned_copies``), since the profiler may drop activity records."""
    log("h2d trace " + json.dumps({**rep, "expected_copies": copies,
                                    "expected_bytes": h2d_bytes}))
    if not 1 <= rep["pinned_copies"] <= copies or len(rep["copy_streams"]) != 1:
        raise AssertionError(f"pinned copies {rep['pinned_copies']} (of {copies}) on "
                             f"streams {rep['copy_streams']}")
    if set(rep["copy_streams"]) & set(rep["kernel_streams"]):
        raise AssertionError(f"the copy stream runs kernels: {rep}")
    if rep["pinned_bytes"] is not None and rep["pinned_bytes"] > h2d_bytes:
        raise AssertionError(f"pinned bytes {rep['pinned_bytes']} > the stream's {h2d_bytes}")
    big = [c for c in rep["other_htod"] if c[1] is None or c[1] > 65536]
    if big:
        raise AssertionError(f"pageable or unsized HtoD copies beyond index vectors: {big}")


def devshm() -> set:
    return set(glob.glob("/dev/shm/psm_*"))


def run_snapshots(card: str, data_dir: Path, c22: dict, fitted: dict) -> tuple[dict, dict]:
    """Phase 24: the snapshot tiers and decode backends on phase 22's tar
    and training split, and on phase 8's VOC test tar with its restored
    bundle.  Returns the phase's kernel launches for the kernels line, and
    what phase 28 reuses: the featurized pass's snapshot root, fitted chain
    and test predictions."""
    jpeglib = subprocess.run(["ls", "/usr/include/jpeglib.h"], capture_output=True, text=True)
    native = native_decode.available()
    pil = importlib.util.find_spec("PIL") is not None
    log(f"phase 24: ls /usr/include/jpeglib.h -> {(jpeglib.stdout or jpeglib.stderr).strip()!r}; "
        f"native_decode.available() = {native}; PIL importable = {pil}; card: {card}")
    t_phase = time.perf_counter()
    rp.launches = rp.fused_launches = jd.launches = jd.decode_launches = fs.launches = 0
    tar, train, conf22 = c22["tar"], c22["train"], c22["conf"]
    empty = LabeledImageBatch(train.images[:0], train.labels[:0])
    chunks = math.ceil(CIFAR_TAR_TEST / conf22.featurize_chunk)
    rec: dict = {"phase": "snapshots and decode backends", "card": card,
                 "jpeglib_h": jpeglib.returncode == 0, "native_decode": native, "pil": pil}
    host_decoder = "native" if native else "pil" if pil else None
    # With neither decoder a host decode raises typed, never skips: shown
    # here by turning both off.
    member = next(iter(image_loaders._iter_tar_members(str(tar))))[1]
    saved_pil = sys.modules.get("PIL")
    sys.modules["PIL"] = None
    try:
        with env_set(KEYSTONE_NATIVE_DECODE="0"):
            native_decode.reset()
            image_loaders.decode_image(member)
    except image_loaders.HostDecoderUnavailable as e:
        rec["no_host_decoder"] = f"raises HostDecoderUnavailable: {e}"
    else:
        raise AssertionError("decode_image decoded with both host decoders off")
    finally:
        if saved_pil is None:
            sys.modules.pop("PIL", None)
        else:
            sys.modules["PIL"] = saved_pil
        native_decode.reset()

    def run(meter, **kw):
        resilience.counters.reset()
        res = cifar.run(dataclasses.replace(conf22, **{"stream_test_tar": str(tar), **kw}),
                        train, empty)
        return res, meter.passes[-1], resilience.counters.snapshot()

    def same(res, want, what):
        if not np.array_equal(res["test_predictions"], want):
            raise AssertionError(f"{what}: predictions differ")

    with StreamedTestPasses() as meter:
        # (a) Featurized tier: the conv features of the test split, keyed
        # by the fitted featurizer's digest.
        feat_root = data_dir / "snap_featurized"
        trace_view = load_trace_view()
        cold_trace = data_dir / "phase24_featurized_cold.json"
        # Deflating the f32 features saved a third of the shard bytes and
        # made the cold pass wait on the consumer (PERF.md §6), so the
        # shards are written plain to keep the phase short.
        with env_set(KEYSTONE_SNAPSHOT_MODE="featurized", KEYSTONE_SNAPSHOT_COMPRESS="0"):
            trace.disable()
            trace.reset()
            trace.enable(str(cold_trace))
            cold, p_cold, _ = run(meter, snapshot_dir=str(feat_root))
            trace.flush()
            trace.disable()
            cold_events = trace_view.load_events(str(cold_trace))
            trace.reset()
            warm, p_warm, _ = run(meter, snapshot_dir=str(feat_root))
            [snap] = [s for s in ksnap.list_snapshots(str(feat_root)) if s["valid"]]
            if not (p_cold["decode_pixels"] >= 2 * chunks and p_cold["conv_rect_pool"] >= chunks
                    and snap["chunks"] == chunks and snap["mode"] == "featurized"):
                raise AssertionError(f"featurized cold pass {p_cold}, snapshot {snap}")
            if (p_warm["decode_pixels"], p_warm["conv_rect_pool"]) != (0, 0) or \
                    p_warm["stats"]["snapshot_chunks_read"] != chunks:
                raise AssertionError(f"featurized warm pass {p_warm}")
            same(cold, c22["predictions"], "featurized cold pass vs phase 22")
            same(warm, c22["predictions"], "featurized warm pass vs phase 22")
            shard = sorted((feat_root / snap["dir"]).glob("chunk_*.npz"))[2]
            data = bytearray(shard.read_bytes())
            data[len(data) // 2] ^= 0x01
            shard.write_bytes(bytes(data))
            healed, p_heal, events = run(meter, snapshot_dir=str(feat_root))
            if events.get("snapshot_fallback") != 1 or ksnap.validate(str(feat_root), snap["key"]):
                raise AssertionError(f"corrupt shard: events {events}, snapshot not rewritten")
            same(healed, c22["predictions"], "featurized fallback pass vs phase 22")
        rec["featurized"] = {
            "cold": {k: p_cold[k] for k in ("conv_rect_pool", "decode_pixels", "seconds")},
            "warm": {k: p_warm[k] for k in ("conv_rect_pool", "decode_pixels", "seconds")},
            "fallback": {k: p_heal[k] for k in ("conv_rect_pool", "decode_pixels", "seconds")},
            "run_seconds": {"cold": cold["seconds"], "warm": warm["seconds"]},
            "shard_bytes": snap["bytes"], "chunks": snap["chunks"],
            "cold_trace_ms": {k: v["total_ms"] for k, v in
                              trace_view.per_stage(cold_events).items()
                              if k.startswith(("ingest.", "snapshot.", "eval"))},
            "cold_overlap": trace_view.overlap_from_spans(cold_events),
        }

        profiled = data_dir / "phase24_stream_trace.json"
        if host_decoder is not None:
            # (b) A host decoder (libjpeg, else PIL): host decode on the
            # thread pool and on spawned workers, then the device tier: the
            # cold pass decodes on the host and writes padded f32 shards,
            # the warm pass copies them (profiled).
            host, p_thread, _ = run(meter, device_decode=False)
            shm_before = devshm()
            # The spawned workers decode the tar's first chunk only: their
            # start-up is most of a pass (PERF.md §6).
            head, head_n = data_dir / "cifar48_test_head.tar", conf22.featurize_chunk
            with tarfile.open(tar) as src, tarfile.open(head, "w") as dst:
                for info in src.getmembers()[:head_n]:
                    dst.addfile(info, src.extractfile(info))
            # Traced, for what starting the workers costs apart from
            # decoding: a spawned worker imports this script's modules
            # (torch among them) before its first task.
            proc_trace = data_dir / "phase24_process.json"
            trace.enable(str(proc_trace))
            proc, p_proc, _ = run(meter, device_decode=False, decode_backend="process",
                                  stream_test_tar=str(head))
            trace.flush()
            trace.disable()
            proc_events = trace_view.load_events(str(proc_trace))
            trace.reset()
            spawn = next(e for e in trace_view.spans(proc_events)
                         if e["name"] == "ingest.spawn_decode_procs")
            first = min(e["ts"] for e in trace_view.instants(proc_events)
                        if e["name"] == "ingest.shm_recv")
            startup = (first - spawn["ts"]) / 1e6
            leftover = multiprocessing.active_children()
            if leftover or devshm() - shm_before:
                raise AssertionError(f"process backend left {leftover} and "
                                     f"{devshm() - shm_before}")
            if proc["test_filenames"] != host["test_filenames"][:head_n]:
                raise AssertionError("the process backend's first chunk is not the tar's")
            same(proc, host["test_predictions"][:head_n], "process backend vs thread backend")
            if (p_thread["stats"]["decoder"], p_proc["stats"]["decoder"]) != ("thread", "process") \
                    or p_proc["stats"]["host_decoder"] != host_decoder:
                raise AssertionError(f"decoders {p_thread['stats']} {p_proc['stats']}")
            dev_root = data_dir / "snap_device"
            with env_set(KEYSTONE_SNAPSHOT_MODE="device"):
                dcold, p_dcold, _ = run(meter, snapshot_dir=str(dev_root))
                meter.profile_next = profiled
                dwarm, p_dwarm, _ = run(meter, snapshot_dir=str(dev_root))
            st = p_dwarm["stats"]
            if p_dcold["stats"]["decoder"] != "thread" or p_dcold["decode_pixels"] != 0 or \
                    p_dcold["stats"]["snapshot_chunks_written"] != chunks:
                raise AssertionError(f"device-tier cold pass {p_dcold}")
            if not (st["snapshot_dma_bytes"] > 0 and st["snapshot_chunks_read"] == chunks
                    and p_dwarm["conv_rect_pool"] == chunks and p_dwarm["decode_pixels"] == 0):
                raise AssertionError(f"device-tier warm pass {p_dwarm}")
            same(dcold, host["test_predictions"], "device tier cold vs host decode")
            same(dwarm, host["test_predictions"], "device tier warm vs cold")
            [dsnap] = [s for s in ksnap.list_snapshots(str(dev_root)) if s["valid"]]
            h2d = h2d_from_trace(profiled)
            check_h2d(h2d, chunks, st["h2d_bytes"])
            rec["host_decode"] = {
                name: {"images": n, "seconds": p["seconds"], "images_per_sec": n / p["seconds"],
                       "decode_seconds": p["stats"]["decode_seconds"]}
                for name, p, n in (("thread", p_thread, CIFAR_TAR_TEST),
                                   ("process", p_proc, head_n))}
            rec["host_decode"]["process"].update(
                workers=spawn["args"].get("procs"), worker_startup_seconds=startup,
                images_per_sec_after_startup=head_n / max(p_proc["seconds"] - startup, 1e-9))
            rec["device_tier"] = {
                "cold_seconds": p_dcold["seconds"], "warm_seconds": p_dwarm["seconds"],
                "shard_bytes": dsnap["bytes"], "snapshot_dma_bytes": st["snapshot_dma_bytes"],
                "h2d_bytes": st["h2d_bytes"], "warm_launches": {
                    k: p_dwarm[k] for k in ("conv_rect_pool", "decode_pixels")}}
        else:
            # (c) No host decoder: the profiled pass is a device-decode
            # stream (coefficients cross).
            meter.profile_next = profiled
            plain, p_plain, _ = run(meter)
            same(plain, c22["predictions"], "device-decode pass vs phase 22")
            st = p_plain["stats"]
            h2d = h2d_from_trace(profiled)
            check_h2d(h2d, 4 * chunks, st["h2d_bytes"])  # 3 planes + quant tables
        rec["h2d_profiled_pass"] = h2d

    # VOC from phase 8's test tar with its restored bundle (test split only).
    tars = fitted["voc_tars"]
    voc_root = data_dir / "snap_voc"
    voc_flags = ["--trainLocation", str(data_dir / "absent"),
                 "--testLocation", str(tars / "test.tar"), "--labelPath", str(tars / "labels.csv"),
                 "--streamIngest", "--streamBatchSize", "64", "--device", "cuda",
                 "--pipelineFile", str(tars / "bundle"), "--snapshotDir", str(voc_root)]
    voc_rec = {}
    if host_decoder is not None:
        # Decoded tier, host decode.  Deflate gains little on these noisy
        # pixels and costs the producer thread, so the shards are written
        # plain (KEYSTONE_SNAPSHOT_COMPRESS=0).
        runs = {}
        with env_set(KEYSTONE_SNAPSHOT_COMPRESS="0"):
            for name in ("cold", "warm"):
                before = fs.launches
                res = voc.main(voc_flags)
                runs[name] = (res, fs.launches - before)
        (vcold, k2_cold), (vwarm, k2_warm) = runs["cold"], runs["warm"]
        sc, sw = vcold["ingest"]["test"], vwarm["ingest"]["test"]
        if not (vcold["map"] == vwarm["map"] and k2_cold > 0 and k2_warm > 0
                and sc["snapshot_chunks_written"] == sc["batches"] > 0
                and sw["snapshot_chunks_read"] == sc["batches"] and sw["decoder"] == ""):
            raise AssertionError(f"VOC decoded tier: MAP {vcold['map']} / {vwarm['map']}, "
                                 f"K2 {k2_cold} / {k2_warm}, stats {sc} / {sw}")
        voc_rec.update(map_host_decode=vcold["map"], cold_seconds=vcold["seconds"],
                       warm_seconds=vwarm["seconds"], fv_stats_launches=[k2_cold, k2_warm],
                       shard_bytes=sum(s["bytes"] for s in ksnap.list_snapshots(str(voc_root))))
    resilience.counters.reset()
    vdev = voc.main([*voc_flags, "--deviceDecode"])
    events = resilience.counters.snapshot()
    if events.get("snapshot_mode_unsupported") != 1 or vdev["map"] != fitted["voc_tar_map"]:
        raise AssertionError(f"VOC device decode with a decoded snapshot: events {events}, "
                             f"MAP {vdev['map']} (phase 8 {fitted['voc_tar_map']})")
    voc_rec.update(map_device_decode=vdev["map"], snapshot_mode_unsupported=1)
    rec["voc"] = voc_rec
    out = {"conv_rect_pool": rp.fused_launches, "decode_pixels": jd.decode_launches,
           "fv_stats": fs.launches}
    if rp.launches or jd.launches:
        raise AssertionError(f"unfused entries launched: {rp.launches} {jd.launches}")
    rec.update(launches=out, seconds=time.perf_counter() - t_phase)
    log(json.dumps(rec))
    return out, {"feat_root": feat_root, "servable": warm["servable"],
                 "predictions": warm["test_predictions"]}


# Serving (phase 25): the default buckets, the bench's requests and clients.
SERVE_BUCKETS = kserve.DEFAULT_BUCKETS
SERVE_BENCH_REQUESTS, SERVE_BENCH_CLIENTS = 1024, 4
# The K1 and K2 kernels' function names in the sources, which a profiled
# replay's trace must hold.
GRAPH_KERNEL_NAMES = {"conv_rect_pool": "pool_kernel", "fv_stats": "fv_stats_kernel"}


def add_launches(total: dict, launches: dict) -> None:
    for name, n in launches.items():
        total[name] = total.get(name, 0) + n


def graph_ms(bucket, reps: int = 20, warmup: int = 2) -> float:
    """Median of ``reps`` replays of one bucket's graph, each between two
    CUDA events on the graph's stream."""
    s = bucket.stream
    with torch.cuda.stream(s):
        for _ in range(warmup):
            bucket.graph.replay()
    s.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(s):
            start.record()
            bucket.graph.replay()
            end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def replay_against_eager(engine, pipe, requests: np.ndarray) -> dict:
    """Per bucket of ``engine`` (built without its parity drop, so every
    configured bucket has its graph): the replay on ``bucket`` rows
    ``torch.equal`` to ``pipe`` at that batch on the same rows, and both
    timed per micro-batch."""
    out = {}
    for bucket, g in sorted(engine._exec.items()):
        x = torch.from_numpy(np.ascontiguousarray(requests[:bucket])).cuda()
        eager = pipe(x)
        replay = engine._execute(bucket, x)
        if not torch.equal(replay, eager):
            raise AssertionError(f"{engine.label}: bucket {bucket}'s replay differs from the "
                                 "eager chain at that batch")
        eager_ms = cuda_ms(lambda: pipe(x), reps=20, warmup=2)
        out[str(bucket)] = {"replay_ms": graph_ms(g), "eager_ms": eager_ms,
                            "kernels": {k: v["launches"] for k, v in g.kernels.items()}}
    return out


def profiled_replay(bucket, want: str, windows: int = 3) -> tuple[str, int, list]:
    """The names of the CUDA kernels one replay of the graph ran, from a
    ``torch.profiler`` window around it, how many windows were taken, and
    the device's own records in the window that is judged.  CUPTI can lose
    a window's device records on a loaded host (the window then holds an
    "Activity Buffer Request" and almost none of the graph's kernels), so a
    window whose device records do not name ``want`` is taken again, up to
    ``windows`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for taken in range(1, windows + 1):
        bucket.stream.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.cuda.stream(bucket.stream):
                bucket.graph.replay()
            bucket.stream.synchronize()
        events = prof.key_averages()
        names = " ".join(sorted({e.key for e in events}))
        device = sorted({e.key for e in events if e.device_type == DeviceType.CUDA}
                        - {"Activity Buffer Request"})
        if any(want in k for k in device):
            break
    return names, taken, device


def batch_dependent_nodes(pipe, x: torch.Tensor) -> list:
    """The nodes of ``pipe`` whose first output row differs between the
    whole batch ``x`` and its first row alone, each node fed the same
    input row either way."""
    out, a, b = [], x, x[:1]
    for node in pipe.nodes:
        a, b = node(a), node(b)
        if not torch.equal(a[:1], b):
            out.append(type(node).__name__ if not hasattr(node, "name") else node.name)
        b = a[:1].clone()
    return out


def engine_line(rec: dict, cold: dict) -> dict:
    return {"label": rec["label"], "cold_start": cold, "live_buckets": rec["live_buckets"],
            "parity_ok": rec["parity_ok"], "parity": rec["parity"],
            "capture_seconds": rec["capture_seconds"], "warmup_seconds": rec["warmup_seconds"],
            "graph_launches": rec["graph_launches"],
            "capture_bytes": {b: p["reported"] for b, p in rec["memory_plans"].items()}}


def check_served(name: str, serving: dict) -> dict:
    s = serving["served"]
    healthy = s["predictions_bit_identical"] or (s.get("parity_unverified")
                                                 and s.get("predictions_deterministic"))
    if not healthy or s["batcher"]["answered"] != s["requests"]:
        raise AssertionError(f"{name}: served answers differ from the offline apply: {s}")
    return {**engine_line(serving["engine"], serving["cold_start"]),
            "requests": s["requests"], "p50_latency_ms": s["p50_latency_ms"],
            "p99_latency_ms": s["p99_latency_ms"], "qps": s["qps"],
            "predictions_bit_identical": s["predictions_bit_identical"],
            "predictions_deterministic": s.get("predictions_deterministic")}


def run_serving(card: str, data_dir: Path, fitted: dict) -> dict:
    """Phase 25: the serving tier on the checkpoints of phases 3, 6 and 9.
    The served path runs with the kernel counts set to 0 just before it and
    read just after (wrapper launches plus graph replays); the replay
    comparisons and timings come after and count nowhere.  Returns the
    served path's launches by kernel."""
    t_phase = time.perf_counter()
    absent = str(data_dir / "absent")
    rec: dict = {"phase": "25: serving (CUDA-graph buckets, batcher, router, wire)",
                 "card": card, "buckets": list(SERVE_BUCKETS)}
    rp.launches = rp.fused_launches = fs.launches = jd.launches = jd.decode_launches = 0
    graphs: dict = {}

    # (a) --serve through the CLIs (VOC through run): restore, serve through
    # the router, answers against the offline apply.
    res = cifar.main(["--trainLocation", absent, "--testLocation", str(fitted["cifar_test"]),
                      *MAIN_FLAGS, "--pipelineFile", str(fitted["cifar_stem"]), "--serve"])
    rec["cifar"] = check_served("cifar", res["serving"])
    add_launches(graphs, res["serving"]["engine"]["graph_launches"])
    mres = mnist.main(["--trainLocation", absent, "--testLocation",
                       str(fitted["mnist"]["test_csv"]), *MNIST_FLAGS,
                       "--pipelineFile", str(fitted["mnist"]["stem"]), "--serve"])
    rec["mnist"] = check_served("mnist", mres["serving"])
    add_launches(graphs, mres["serving"]["engine"]["graph_launches"])
    vconf = voc.SIFTFisherConfig(**VOC_CONF, pipeline_file=str(fitted["voc_stem"]), serve=True)
    vres = voc.run(vconf, MultiLabeledImages([], [], []), fitted["voc_test"])
    rec["voc"] = {**check_served("voc", vres["serving"]),
                  "request_shape": vres["serving"]["request_shape"]}
    # The served VOC rows no longer round with the row count
    # (utils.stats.matmul_rows), so every bucket holds parity and stays live.
    veng_rec = vres["serving"]["engine"]
    if veng_rec["live_buckets"] != list(SERVE_BUCKETS) or not veng_rec["parity_ok"]:
        raise AssertionError(f"VOC serving kept buckets {veng_rec['live_buckets']} of "
                             f"{list(SERVE_BUCKETS)} (parity {veng_rec['parity']})")
    add_launches(graphs, vres["serving"]["engine"]["graph_launches"])

    # (b) The SLO bench on 1,024 Cifar requests.
    images = cifar_loader(str(fitted["cifar_test"])).images
    cifar_req = np.asarray(images[:SERVE_BENCH_REQUESTS], np.float32)
    ceng, ccold = kserve.load_engine(str(fitted["cifar_stem"]), np.empty((32, 32, 3), np.float32),
                                     label="cifar_bench")
    bench = kserve.serve_bench(ceng, cifar_req, clients=SERVE_BENCH_CLIENTS, depth=4)
    if not (bench["predictions_bit_identical"] and bench["unbatched_bit_identical"]):
        raise AssertionError(f"bench answers differ from the offline apply: {bench}")
    rec["bench"] = {**{k: bench[k] for k in ("requests", "clients", "qps", "p50_latency_ms",
                                             "p99_latency_ms", "max_latency_ms", "unbatched_qps",
                                             "batched_vs_unbatched_qps")},
                    "mean_occupancy": bench["batcher"]["mean_occupancy"],
                    "batches": bench["batcher"]["batches"],
                    "phase_breakdown": bench["phase_breakdown"],
                    "engine": engine_line(ceng.record(), ccold)}
    offline = ceng.offline(cifar_req)

    # (c) A wire round trip over localhost.
    with kfrontend.ShapeRouter(label="cifar_wire") as router:
        router.add_engine(ceng)
        with wire.WireServer(router, port=0) as ws:
            with wire.WireClient(port=ws.port, timeout=60.0) as client:
                ping = client.ping()
                got = np.stack(client.predict_many(list(cifar_req[:256]), window=16))
            wire_stats = ws.record()["stats"]
    if not np.array_equal(got, offline[:256]):
        raise AssertionError("answers over the wire differ from the offline apply")
    rec["wire"] = {"requests": 256, "ping_ms": 1e3 * ping, "equal": True, **wire_stats}

    # (d) A warm add of an engine for VOC's second shape while Cifar
    # traffic is live: every Cifar request answered, equal.
    shapes = sorted({img.shape for img in fitted["voc_test"].images},
                    key=lambda sh: -sum(img.shape == sh for img in fitted["voc_test"].images))
    second = np.asarray([img for img in fitted["voc_test"].images if img.shape == shapes[1]][:1],
                        np.float32)
    warmed: list = []

    def factory(shape, dtype):
        eng, cold = kserve.load_engine(
            str(fitted["voc_stem"]), np.empty(shape, np.float32),
            label=kfrontend.shape_label("voc", shape),
            wrap=lambda bundle: voc.servable_pipeline(vconf, bundle))
        warmed.append((eng, cold))
        return eng

    answers: list = []
    errors: list = []
    stop = threading.Event()
    with kfrontend.ShapeRouter(factory, label="warm_add",
                               config=kfrontend.RouterConfig(warm_threshold=1)) as router:
        router.add_engine(ceng)

        def traffic():
            try:
                i = 0
                while not stop.is_set():
                    futs = [(j % len(cifar_req), router.submit(cifar_req[j % len(cifar_req)]))
                            for j in range(i, i + 16)]
                    answers.extend((j, f.result(60.0)) for j, f in futs)
                    i += 16
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        t = threading.Thread(target=traffic)
        t.start()
        time.sleep(0.2)
        before = len(answers)
        t0 = time.perf_counter()
        voc_answer = router.predict(second[0], timeout=300.0)
        warm_secs = time.perf_counter() - t0
        during = len(answers) - before
        stop.set()
        t.join(120.0)
        router_stats = router.record()["stats"]
    if errors or not all(np.array_equal(a, offline[j]) for j, a in answers):
        raise AssertionError(f"Cifar traffic during the warm add: {errors[:1]}, "
                             f"{len(answers)} answers")
    veng, vcold = warmed[0]
    if not (router_stats["warm_adds"] == 1 and voc_answer.shape == (VOC_NUM_CLASSES,)):
        raise AssertionError(f"warm add: {router_stats}, answer {voc_answer.shape}")
    rec["warm_add"] = {"shape": list(shapes[1]), "seconds": warm_secs,
                       "cifar_answers": len(answers), "cifar_answers_during_warm": during,
                       "lost": 0, "router": router_stats, "engine": engine_line(veng.record(), vcold)}
    add_launches(graphs, ceng.graph_launches())
    add_launches(graphs, veng.graph_launches())
    served = {"conv_rect_pool": rp.fused_launches + graphs.get("conv_rect_pool", 0),
              "fv_stats": fs.launches + graphs.get("fv_stats", 0)}
    rec["launches"] = {"served_path": served, "graph_replays": graphs,
                       "eager": {"conv_rect_pool": rp.fused_launches, "fv_stats": fs.launches}}
    if not (graphs.get("conv_rect_pool") and graphs.get("fv_stats")) or rp.launches or jd.launches:
        raise AssertionError(f"the served path's launches: {rec['launches']}, unfused "
                             f"{rp.launches} {jd.launches}")
    rec["served_path_seconds"] = time.perf_counter() - t_phase

    # (e) Not counted: each chain's replay against its eager run at every
    # bucket, timed, and one profiled replay per kernel.
    chains = {
        "cifar": (load_pipeline(str(fitted["cifar_stem"])), cifar_req),
        "mnist": (load_pipeline(str(fitted["mnist"]["stem"])),
                  np.asarray(fitted["mnist"]["test"].data[:64], np.float32)),
        "voc": (voc.servable_pipeline(vconf, load_pipeline(str(fitted["voc_stem"]))),
                np.asarray([img for img in fitted["voc_test"].images
                            if img.shape == shapes[0]][:64], np.float32)),
    }
    rec["replay_against_eager"] = {}
    for name, (pipe, reqs) in chains.items():
        eng = kserve.ServingEngine(pipe, np.empty(reqs.shape[1:], np.float32), warmup=False,
                                   label=f"{name}_timed")
        rec["replay_against_eager"][name] = replay_against_eager(eng, pipe, reqs)
        rec["replay_against_eager"][name]["batch_dependent_nodes_1_vs_64"] = (
            batch_dependent_nodes(pipe, torch.from_numpy(np.ascontiguousarray(reqs[:64])).cuda()))
        for kernel, fn in GRAPH_KERNEL_NAMES.items():
            g = eng._exec[SERVE_BUCKETS[-1]]
            if kernel in g.kernels:
                names, windows, device = profiled_replay(g, fn)
                # The judged window must hold the device's kernel records,
                # never only CUPTI's buffer request.
                if not any(fn in k for k in device):
                    raise AssertionError(f"{name}: {windows} profiled replays hold no device "
                                         f"record of {fn}: {names[:500]}")
                rec["replay_against_eager"][name]["profiled_replay_names"] = fn
                rec["replay_against_eager"][name]["profiler_windows"] = windows
                rec["replay_against_eager"][name]["profiled_device_records"] = len(device)
        del eng
        torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(json.dumps(rec))
    return served


# Phase 26, the solver ladder: VOC's fit killed after block VOC_KILL_BLOCK of
# its 10 and resumed; TIMIT config 4's solve under TIMIT_FLOOR_BUDGET, which
# denies both device tiers (fused charges the caller's 26.8 GB of blocks and
# their concatenation, stepwise the blocks and the 3.4 GB factor cache), so
# the host-staged floor runs; the weighted solve at ImageNet's width (config
# 5: 4,096 features, 1,000 classes, two rows each) in blocks of BWLS_BLOCK,
# four blocks, where each tier's total differs (at the workload's one block
# of 4,096 fused and stepwise hold the same memory).
VOC_KILL_BLOCK = 4
TIMIT_FLOOR_BUDGET = "16G"
BWLS_ROWS, BWLS_WIDTH, BWLS_BLOCK = 2000, 4096, 1024


class Preempted(RuntimeError):
    """Phase 26's simulated preemption of the VOC fit."""


class SolvePeak:
    """Seconds and peak device memory of each block-solver fit while
    active (it wraps ``BlockLeastSquaresEstimator.fit``; the peak statistics
    are reset as the fit starts)."""

    def __enter__(self) -> list:
        self.fits = []
        self._orig = orig = BlockLeastSquaresEstimator.fit

        def fit(est, *args, **kw):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            try:
                return orig(est, *args, **kw)
            finally:
                torch.cuda.synchronize()
                self.fits.append({"seconds": time.perf_counter() - t,
                                  "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

        BlockLeastSquaresEstimator.fit = fit
        return self.fits

    def __exit__(self, *exc) -> None:
        BlockLeastSquaresEstimator.fit = self._orig


def killing_writer(real, written: list, kill_block):
    """A stand-in for ``solvers.block.bcd_checkpoint_writer``: the real
    writer, recording each state's (epoch, block), that raises
    :class:`Preempted` once block ``kill_block`` is written (never when
    None)."""

    def make(path):
        write = real(path)

        def cb(state):
            write(state)
            written.append((state["epoch"], state["block"]))
            if state["block"] == kill_block:
                raise Preempted(f"preempted after block {kill_block}")

        return cb

    return make


def run_ladder(card: str, data_dir: Path, phase6: dict, timit12: dict) -> dict:
    """Phase 26: the block solvers' ladder and the resumable state on the
    card.  (a) VOCSIFTFisher at phase 6's configuration and images through
    ``voc.run`` with ``solve_checkpoint``, killed after block 4, then run
    again: it resumes at epoch 0 block 5, with phase 6's MAP, test scores
    within 1e-5·max of phase 6's, and the state removed; (b) the same run
    under two capacity budgets read from the reports (below phase 6's
    fused total, then below the stepwise total): stepwise, then
    host_staged, each MAP within 1e-4 of phase 6's; (c) TIMIT config 4 on
    phase 12's frames through ``timit.run`` on the host-staged floor: test
    error within 0.05 points of phase 12's and a finite model; (d) the
    weighted solve of seeded features at ImageNet's width under each tier,
    within rtol 1e-4, atol 1e-5·max of the fused fit.  K2 must launch in
    every VOC run.  Returns the phase's K2 launches."""
    launches = 0
    train, test = phase6["train"], phase6["test"]
    state = data_dir / "voc_solve_state"
    conf = voc.SIFTFisherConfig(**VOC_CONF, solve_checkpoint=str(state))
    real_writer = block_mod.bcd_checkpoint_writer
    records = {}

    # (a) Killed after block 4, then resumed from the state on disk.
    for name, kill in (("killed", VOC_KILL_BLOCK), ("resumed", None)):
        written: list = []
        block_mod.bcd_checkpoint_writer = killing_writer(real_writer, written, kill)
        fs.launches = 0
        try:
            with SolvePeak() as fits:
                try:
                    res = voc.run(conf, train, test)
                except Preempted:
                    res = None
        finally:
            block_mod.bcd_checkpoint_writer = real_writer
        launches += fs.launches
        torch.cuda.empty_cache()
        if not fs.launches:
            raise AssertionError(f"VOC {name} run launched no fv_stats")
        if name == "killed":
            if res is not None or written[-1] != (0, VOC_KILL_BLOCK) or not os.path.exists(
                    block_mod.bcd_checkpoint_path(state)):
                raise AssertionError(f"VOC fit was not killed after block {VOC_KILL_BLOCK} "
                                     f"with its state on disk: states {written}")
            records[name] = {"states_written": len(written), "fv_stats_launches": fs.launches,
                             **fits[0]}
            continue
        if written[0] != (0, VOC_KILL_BLOCK + 1):
            raise AssertionError(f"the resumed VOC fit started at {written[0]}, expected "
                                 f"(0, {VOC_KILL_BLOCK + 1})")
        if os.path.exists(block_mod.bcd_checkpoint_path(state)):
            raise AssertionError("the VOC solve state was not removed after the fit")
        scores, want = res["test_scores"], phase6["scores"]
        err = float(np.abs(scores - want).max())
        if res["map"] != phase6["map"] or not err <= 1e-5 * np.abs(want).max():
            raise AssertionError(f"resumed VOC MAP {res['map']} vs phase 6's {phase6['map']}, "
                                 f"scores max abs err {err}")
        records[name] = {"resumed_at": list(written[0]), "map": res["map"],
                         "map_equal_phase6": True, "scores_max_abs_err": err,
                         "scores_bit_equal_phase6": bool(np.array_equal(scores, want)),
                         "chosen_tier": res["fit_report"]["chosen_tier"],
                         "solve_seconds": res["solve_seconds"], "fv_stats_launches": fs.launches,
                         **fits[0]}

    # (b) Two budgets between the tiers' totals, read from the reports (the
    # reports round to 1 MiB; the totals are tens of MB apart).
    conf = voc.SIFTFisherConfig(**VOC_CONF)
    total_gb = phase6["fit_report"]["tiers"]["fused"]["total_gb"]
    for tier in ("stepwise", "host_staged"):
        budget = int((total_gb - 0.002) * 2**30)
        fs.launches = 0
        with env_set(KEYSTONE_HBM_BUDGET=str(budget)), SolvePeak() as fits:
            res = voc.run(conf, train, test)
        launches += fs.launches
        torch.cuda.empty_cache()
        rep = res["fit_report"]
        if rep["chosen_tier"] != tier or not fs.launches:
            raise AssertionError(f"VOC under a {budget} B budget ran {rep['chosen_tier']}, "
                                 f"expected {tier}; fv_stats launches {fs.launches}")
        if not abs(res["map"] - phase6["map"]) <= 1e-4:
            raise AssertionError(f"VOC {tier} MAP {res['map']} vs phase 6's {phase6['map']}")
        records[tier] = {"budget_bytes": budget, "denials": rep["denials"], "map": res["map"],
                         "solve_seconds": res["solve_seconds"],
                         "fv_stats_launches": fs.launches, **fits[0]}
        if tier == "stepwise":
            total_gb = rep["tiers"]["stepwise"]["total_gb"]
    blocks = math.ceil(2 * VOC_CONF["desc_dim"] * VOC_CONF["vocab_size"] / 4096)
    log(json.dumps({"phase": "26 VOC solver ladder", "card": card, "blocks": blocks,
                    "phase6_map": phase6["map"], "runs": records}))

    # (c) TIMIT config 4 on the host-staged floor.
    torch.cuda.empty_cache()
    n, nb, bs = TIMIT_TRAIN, 50, 4096
    with env_set(KEYSTONE_HBM_BUDGET=TIMIT_FLOOR_BUDGET), SolvePeak() as fits:
        res = timit.run(timit.TimitConfig(device="cuda"), timit12["data"])
    rep = res["fit_report"]
    if rep["chosen_tier"] != "host_staged" or rep["denials"] != ["fused", "stepwise"]:
        raise AssertionError(f"TIMIT under {TIMIT_FLOOR_BUDGET} ran {rep['chosen_tier']} "
                             f"(denied {rep['denials']}), expected host_staged")
    # The caller's blocks, the factor cache and one uploaded block and its
    # centred copy.
    estimate_gb = (n * nb * bs + nb * bs * bs + 2 * n * bs) * 4 / 1e9
    rec = timit_record(res, fits[0]["peak_memory_gb"], estimate_gb)
    if not abs(rec["test_error"] - timit12["test_error"]) <= 0.05:
        raise AssertionError(f"TIMIT host-staged test error {rec['test_error']} vs phase 12's "
                             f"{timit12['test_error']}")
    log(json.dumps({"phase": "26 TIMIT config 4 on the host-staged floor", "card": card,
                    "budget": TIMIT_FLOOR_BUDGET, "denials": rep["denials"], **rec,
                    "solve_wall_seconds": fits[0]["seconds"],
                    "phase12_fused": {k: timit12[k] for k in (
                        "test_error", "solve_seconds", "peak_memory_gb")}}))
    del res
    torch.cuda.empty_cache()

    # (d) The weighted solve at ImageNet's width under each tier.
    inet_conf = inet.ImageNetSiftLcsFVConfig()
    labels = np.random.default_rng(29).permutation(
        np.repeat(np.arange(IMAGENET_CLASSES), BWLS_ROWS // IMAGENET_CLASSES))
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn((BWLS_ROWS, BWLS_WIDTH), generator=gen, device="cuda")
    y = torch.as_tensor(2.0 * np.eye(IMAGENET_CLASSES, dtype=np.float32)[labels] - 1.0,
                        device="cuda")
    budget, bwls = "64G", {}
    for tier in ("fused", "stepwise", "host_staged"):
        est = BlockWeightedLeastSquaresEstimator(BWLS_BLOCK, 1, inet_conf.lam,
                                                 inet_conf.mixture_weight)
        with env_set(KEYSTONE_HBM_BUDGET=budget):
            torch.cuda.synchronize()
            t = time.perf_counter()
            model = est.fit(x, y)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        if est.last_fit_report.chosen != tier:
            raise AssertionError(f"BWLS under {budget} B ran {est.last_fit_report.chosen}, "
                                 f"expected {tier}")
        weights = torch.cat(model.xs)
        bwls[tier] = {"seconds": secs, "weights": weights, "b": model.b,
                      "total_bytes": est.last_fit_report.plans[tier].total_bytes}
        budget = str(bwls[tier]["total_bytes"] - 1)
    want = bwls["fused"]["weights"]
    errs = {}
    for tier in ("stepwise", "host_staged"):
        got = bwls[tier]["weights"]
        errs[tier] = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * float(want.abs().max()))
    log(json.dumps({"phase": "26 weighted solve at ImageNet's width", "card": card,
                    "rows": BWLS_ROWS, "features": BWLS_WIDTH, "block": BWLS_BLOCK,
                    "classes": IMAGENET_CLASSES, "lam": inet_conf.lam,
                    "mixture_weight": inet_conf.mixture_weight,
                    "seconds": {t: r["seconds"] for t, r in bwls.items()},
                    "total_bytes": {t: r["total_bytes"] for t, r in bwls.items()},
                    "max_abs_err_vs_fused": errs,
                    "stepwise_equal_fused": bool(torch.equal(bwls["stepwise"]["weights"], want))}))
    fused = {"weights": want.cpu(), "b": bwls["fused"]["b"].cpu(),
             "seconds": bwls["fused"]["seconds"]}
    del x, y, bwls, want
    torch.cuda.empty_cache()
    # Phase 30 holds the mesh fits of the same problem to the fused one.
    return {"fv_stats": launches, "bwls_fused": fused}


# Phase 27, the optimizer.  At the default exchange rate (1 GB/s) holding
# phase 6's 12.1 GB of projected training descriptors (512 x 80 x 73,866
# f32) is priced far above the card's re-projection, so the plan declines
# it; VOC_CACHE_GBPS prices memory at about a third of the card's bandwidth,
# where the plan wants the cache and the admission gate decides.
# VOC_DENY_BUDGET is a capacity whose half (the gate's headroom) is below
# 12.1 GB and far above every other admission of the run (the fused solve
# holds 84 MB of features).
VOC_CACHE_GBPS = "1000"
VOC_DENY_BUDGET = "16G"


def run_optimizer(card: str, fitted: dict, c22: dict, phase6: dict) -> dict:
    """Phase 27(a)-(c): ``--autoCache`` on RandomPatchCifar (phase 3's files)
    and on VOCSIFTFisher (phase 6's images, admitted and denied), and
    ``--autoTune`` on phase 22's streamed tar, each against the run without
    the flag.  Each path runs with the kernel counts set to 0 just before
    it and read just after.  Returns the launches by kernel."""
    rec: dict = {"phase": "27: the auto-Cacher and the ingest autotuner", "card": card}
    total = {"conv_rect_pool": 0, "fv_stats": 0, "decode_pixels": 0}

    # (a) Cifar: the conv features of the fit replayed for the fitted apply.
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rp.launches = rp.fused_launches = 0
    res = cifar.main(["--trainLocation", str(fitted["cifar_train"]), "--testLocation",
                      str(fitted["cifar_test"]), *MAIN_FLAGS, "--autoCache"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    k1 = rp.fused_launches
    total["conv_rect_pool"] += k1
    plan = res["cache_plan"]
    train_chunks = math.ceil(N_TRAIN / 2048)
    rec["cifar_auto_cache"] = {
        "cached": plan["cached"], "decisions": plan["decisions"],
        "dataset_rows": plan["dataset_rows"], "sample_rows": plan["sample_rows"],
        "conv_rect_pool_launches": k1,
        "phase3_conv_rect_pool_launches": fitted["cifar_fit_launches"],
        "uncached_training_featurize_launches": train_chunks,
        "featurize_seconds": res["featurize_seconds"],
        "phase3_featurize_seconds": fitted["cifar_featurize_seconds"],
        "seconds": res["seconds"], "phase3_seconds": fitted["cifar_seconds"],
        "peak_memory_gb": peak_gb, "phase3_peak_memory_gb": fitted["cifar_peak_gb"],
        "predictions_equal_phase3": bool(np.array_equal(res["test_predictions"],
                                                        fitted["cifar_pred"])),
    }
    log(json.dumps(rec["cifar_auto_cache"]))
    # Phase 3's fit path featurizes the training split once; the cached chain
    # adds the optimizer's four passes over its one-chunk sample (warm-up,
    # profile, and the fit pattern's two applications), where an uncached
    # chain would featurize the training split twice.
    if plan["cached"] != ["conv_featurize"] or k1 != fitted["cifar_fit_launches"] + 4:
        raise AssertionError(f"Cifar --autoCache: cached {plan['cached']}, K1 {k1} against "
                             f"phase 3's {fitted['cifar_fit_launches']} + 4")
    if not rec["cifar_auto_cache"]["predictions_equal_phase3"]:
        raise AssertionError("Cifar --autoCache predictions differ from phase 3's")

    # (b) Phase 22's tar with the autotuner evaluating every chunk.
    rp.launches = rp.fused_launches = jd.launches = jd.decode_launches = 0
    train = c22["train"]
    with env_set(KEYSTONE_AUTOTUNE_INTERVAL="1"):
        tuned = cifar.run(dataclasses.replace(c22["conf"], stream_test_tar=str(c22["tar"]),
                                              auto_tune=True),
                          train, LabeledImageBatch(train.images[:0], train.labels[:0]))
    launches = {"conv_rect_pool": rp.fused_launches, "decode_pixels": jd.decode_launches,
                "rect_pool": rp.launches, "idct_blocks": jd.launches}
    total["conv_rect_pool"] += launches["conv_rect_pool"]
    total["decode_pixels"] += launches["decode_pixels"]
    at = tuned["autotune"]
    rec["cifar_tar_auto_tune"] = {
        "retunes": at["retunes"], "trajectory": at["trajectory"],
        "final_config": at["final_config"], "launches": launches,
        "seconds": tuned["seconds"], "ingest": tuned["ingest"],
        "predictions_equal_phase22": bool(np.array_equal(tuned["test_predictions"],
                                                         c22["predictions"])),
    }
    log(json.dumps(rec["cifar_tar_auto_tune"]))
    if not (rec["cifar_tar_auto_tune"]["predictions_equal_phase22"]
            and launches["conv_rect_pool"] and launches["decode_pixels"]
            and not (launches["rect_pool"] or launches["idct_blocks"])):
        raise AssertionError(f"Cifar --autoTune: {rec['cifar_tar_auto_tune']}")

    # (c) VOC: the projected training descriptors at the default rate, then
    # wanted and admitted, then wanted and denied by the budget.
    runs = (("default_rate", {}),
            ("admitted", {"KEYSTONE_CACHE_GBPS": VOC_CACHE_GBPS}),
            ("denied", {"KEYSTONE_CACHE_GBPS": VOC_CACHE_GBPS,
                        "KEYSTONE_HBM_BUDGET": VOC_DENY_BUDGET}))
    for label, env in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fs.launches = 0
        conf = voc.SIFTFisherConfig(**VOC_CONF, auto_cache=True)
        with env_set(**env):
            vres = voc.run(conf, phase6["train"], phase6["test"])
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        total["fv_stats"] += fs.launches
        vplan = vres["cache_plan"]
        rec[f"voc_auto_cache_{label}"] = {
            "cached": vplan["cached"], "dropped": vplan["dropped"],
            "decisions": vplan["decisions"],
            "budget_bytes": vplan["budget_bytes"], "map": vres["map"],
            "phase6_map": phase6["map"], "fv_stats_launches": fs.launches,
            "peak_memory_gb": peak_gb, "seconds": vres["seconds"],
            **{k: vres[k] for k in ("sift_seconds", "pca_seconds", "gmm_seconds",
                                    "fisher_seconds", "solve_seconds")},
            "scores_equal_phase6": bool(np.array_equal(vres["test_scores"], phase6["scores"])),
        }
        log(json.dumps(rec[f"voc_auto_cache_{label}"]))
        # The default rate's verdict follows the measured seconds; the
        # other two are fixed by the rate and the budget.
        want = {"admitted": (["voc_pca_descriptors"], []),
                "denied": ([], ["voc_pca_descriptors"])}.get(label)
        if not ((want is None or (vplan["cached"], vplan["dropped"]) == want)
                and vres["map"] == phase6["map"] and fs.launches
                and rec[f"voc_auto_cache_{label}"]["scores_equal_phase6"]):
            raise AssertionError(f"VOC --autoCache ({label}): {rec[f'voc_auto_cache_{label}']}")
    return total


def run_imagenet_restored(card: str, test: LabeledImages, saved: dict) -> int:
    """Phase 27(d): phase 17's ImageNetSiftLcsFV bundle restored from its
    ``--pipelineFile`` checkpoint (no training data, no fit) and applied to
    phase 17's test split: scores ``np.array_equal`` to phase 17's, the same
    top-5 error, K2 launched.  Returns K2's launches."""
    conf = inet.ImageNetSiftLcsFVConfig(num_classes=IMAGENET_CLASSES, device="cuda",
                                        pipeline_file=str(saved["stem"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fs.launches = 0
    res = inet.run(conf, LabeledImages([], np.zeros(0, np.int32), []), test)
    launches = fs.launches
    rec = {"phase": "27(d): ImageNetSiftLcsFV restored (--pipelineFile)", "card": card,
           "restored": res.get("restored", False), "test_images": len(test),
           "top5_err_percent": res["top5_err_percent"],
           "phase17_top5_err_percent": saved["top5_err_percent"],
           "seconds": res["seconds"], "phase17_fitted_seconds": saved["seconds"],
           "fv_stats_launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "scores_equal_phase17": bool(np.array_equal(res["test_scores"], saved["scores"]))}
    log(json.dumps(rec))
    if not (rec["restored"] and rec["scores_equal_phase17"] and launches
            and res["top5_err_percent"] == saved["top5_err_percent"]):
        raise AssertionError(f"ImageNet restored: {rec}")
    return launches


# Phase 28, the placement search and the closed lifecycle.  The lifecycle
# deployment serves phase 22's 48 px chain at the default buckets; its
# drifted request mix is LIFECYCLE_SHIFTED images of class 0 alone, its
# holdout LIFECYCLE_HOLDOUT balanced images of the same recipe, and the
# quality gate (holdout accuracy) allows LIFECYCLE_MARGIN.
LIFECYCLE_SHIFTED, LIFECYCLE_HOLDOUT, LIFECYCLE_MARGIN = 256, 512, 0.01


def load_plan_view():
    """``tools/plan_view.py`` of this checkout, loaded by path (it imports
    no JAX; the port itself imports nothing from ``tools/``)."""
    spec = importlib.util.spec_from_file_location(
        "plan_view", Path(__file__).resolve().parent / "tools" / "plan_view.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def placement_line(p: dict) -> dict:
    """The placement record's ranking, chosen plan, search seconds and each
    candidate's prior, calibration and predicted against measured seconds."""
    return {"ranking": p["ranking"], "chosen": p["chosen"], "trained": p["trained"],
            "margin": p["margin"], "devices": p["devices"],
            "search_seconds": p["search_seconds"],
            "predicted_seconds": p["predicted_seconds"],
            "measured_seconds": p["measured_seconds"],
            "prediction_error": p["prediction_error"],
            "candidates": {c["name"]: {k: c[k] for k in (
                "prior_rank", "raw_seconds", "calibration", "calibration_source",
                "predicted_seconds", "measured_seconds", "outcome")} for c in p["candidates"]}}


def run_placement(card: str, fitted: dict, phase6: dict, timit12: dict) -> dict:
    """Phase 28(a)-(e): the placement search on the card.  Returns the
    launches of (a), (b) and (d) by kernel."""
    rec: dict = {"phase": "28(a)-(e): the placement search", "card": card}
    launches = {"conv_rect_pool": 0, "fv_stats": 0}
    cifar_argv = ["--trainLocation", str(fitted["cifar_train"]), "--testLocation",
                  str(fitted["cifar_test"]), *MAIN_FLAGS]

    # (a) Cifar --autoShard on phase 3's files, then the hand ladder.
    torch.cuda.empty_cache()
    rp.launches = rp.fused_launches = 0
    searched = cifar.main([*cifar_argv, "--autoShard"])
    launches["conv_rect_pool"] += rp.fused_launches
    k1 = rp.fused_launches
    with env_set(KEYSTONE_AUTOSHARD="0"):
        hand = cifar.main(cifar_argv)
    placement = searched["placement"]
    rec["cifar"] = {
        "placement": placement_line(placement), "conv_rect_pool_launches": k1,
        "solve_seconds": {"searched": searched["solve_seconds"],
                          "hand": hand["solve_seconds"]},
        "search_overhead_seconds": searched["solve_seconds"] - hand["solve_seconds"],
        "predictions_equal_phase3": bool(np.array_equal(searched["test_predictions"],
                                                        fitted["cifar_pred"])),
        "hand_placement": hand.get("placement")}
    log(json.dumps(rec["cifar"]))
    if not (rec["cifar"]["predictions_equal_phase3"] and k1 and "placement" not in hand
            and placement["chosen"] == searched["fit_report"]["chosen_tier"]
            and np.array_equal(hand["test_predictions"], fitted["cifar_pred"])):
        raise AssertionError(f"Cifar --autoShard: {rec['cifar']}")

    # (b) VOC --autoShard on phase 6's images.
    torch.cuda.empty_cache()
    fs.launches = 0
    vres = voc.run(voc.SIFTFisherConfig(**VOC_CONF, auto_shard=True), phase6["train"],
                   phase6["test"])
    launches["fv_stats"] += fs.launches
    rec["voc"] = {"placement": placement_line(vres["placement"]), "map": vres["map"],
                  "phase6_map": phase6["map"], "fv_stats_launches": fs.launches,
                  "solve_seconds": vres["solve_seconds"],
                  "scores_equal_phase6": bool(np.array_equal(vres["test_scores"],
                                                             phase6["scores"]))}
    log(json.dumps(rec["voc"]))
    if not (rec["voc"]["scores_equal_phase6"] and vres["map"] == phase6["map"] and fs.launches):
        raise AssertionError(f"VOC --autoShard: {rec['voc']}")
    del vres

    # (c) TIMIT config 4 on phase 12's frames, searched (the default), then
    # on the hand ladder: the ranking the JAX rules give on the card's rates.
    torch.cuda.empty_cache()
    runs = {}
    for name, env in (("searched", {}), ("hand", {"KEYSTONE_AUTOSHARD": "0"})):
        with env_set(**env), SolvePeak() as fits:
            res = timit.run(timit.TimitConfig(device="cuda"), timit12["data"])
        runs[name] = (res["test_scores"].argmax(axis=1), res["fit_report"], fits[0],
                      res["solve_seconds"])
        del res
        torch.cuda.empty_cache()
    tp = runs["searched"][1]["placement"]
    rec["timit"] = {
        "placement": placement_line(tp), "cost_model": dataclasses.asdict(
            kopt.CostModel.for_devices()),
        "solve_seconds": {k: v[3] for k, v in runs.items()},
        "fit_wall_seconds": {k: v[2]["seconds"] for k, v in runs.items()},
        "peak_memory_gb": {k: v[2]["peak_memory_gb"] for k, v in runs.items()},
        "search_overhead_seconds": runs["searched"][3] - runs["hand"][3],
        "phase12": {k: timit12[k] for k in ("test_error", "solve_seconds", "peak_memory_gb")},
        "predictions_equal_phase12": bool(np.array_equal(runs["searched"][0],
                                                         timit12["predictions"])),
        "predictions_equal_hand": bool(np.array_equal(runs["searched"][0], runs["hand"][0]))}
    log(json.dumps(rec["timit"]))
    if not (rec["timit"]["predictions_equal_phase12"] and rec["timit"]["predictions_equal_hand"]
            and runs["hand"][1]["placement"] is None):
        raise AssertionError(f"TIMIT searched: {rec['timit']}")

    # (d) plan_mispredict: the top-ranked plan of (a)'s fit dies out of
    # memory at its run; the fit steps down the searched ranking, counted.
    torch.cuda.empty_cache()
    real, calls = block_mod._fused_bcd_impl, {"n": 0}

    def dying(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise torch.OutOfMemoryError("CUDA out of memory (injected at the ranked head)")
        return real(*args, **kw)

    rp.launches = rp.fused_launches = 0
    before = resilience.counters.get("autoshard_stepdown")
    block_mod._fused_bcd_impl = dying
    try:
        faulted = cifar.main([*cifar_argv, "--autoShard"])
    finally:
        block_mod._fused_bcd_impl = real
    launches["conv_rect_pool"] += rp.fused_launches
    fp = faulted["placement"]
    rec["plan_mispredict"] = {
        "ranking": fp["ranking"], "chosen": fp["chosen"],
        "oom_retries": faulted["fit_report"]["oom_retries"],
        "autoshard_stepdown": resilience.counters.get("autoshard_stepdown") - before,
        "conv_rect_pool_launches": rp.fused_launches,
        "predictions_equal_a": bool(np.array_equal(faulted["test_predictions"],
                                                   searched["test_predictions"]))}
    log(json.dumps(rec["plan_mispredict"]))
    if not (fp["chosen"] == fp["ranking"][1] and rec["plan_mispredict"]["autoshard_stepdown"] == 1
            and rec["plan_mispredict"]["predictions_equal_a"]):
        raise AssertionError(f"plan_mispredict: {rec['plan_mispredict']}")
    del searched, hand, faulted

    # (e) The plan log (a)-(d) wrote, and tools/plan_view.py's summary of it.
    path = autoshard.plan_log_path()
    with open(path) as f:
        rows = [json.loads(ln) for ln in f if ln.strip()]
    summary = load_plan_view().summarize(path)
    rec["plan_log"] = {"path": path, "rows": len(rows),
                       "outcomes": {o: sum(r["outcome"] == o for r in rows)
                                    for o in sorted({r["outcome"] for r in rows})}}
    log(json.dumps(rec["plan_log"]))
    log("plan_view summary of the plan log:\n" + summary)
    if not rows or rec["plan_log"]["outcomes"].get("oom") != 1:
        raise AssertionError(f"plan log: {rec['plan_log']}")
    return launches


def run_lifecycle(card: str, data_dir: Path, c22: dict, snap24: dict) -> dict:
    """Phase 28(f): the closed lifecycle on the card.  Phase 22's fitted
    chain (from phase 24's warm pass) is saved with its test predictions'
    sketch and served through the shape router at the default buckets
    (CUDA graphs).  The refit's training set is committed once from phase
    24's featurized snapshot of phase 22's tar (its conv features, labels
    from the member names; no decode, no featurize), keyed by the
    featurizer's digest.  Then, with the kernel counts at 0, the numerics
    observatory on and traffic live: a mix of class 0 alone trips the drift
    monitor; the controller's watcher warm-refits over the committed set
    (``source == "snapshot"``, no featurizer call), validates, and hot-swaps
    while requests run; post-swap answers equal the offline refit's; the
    mix trips the swapped engine's monitor inside the cooldown, a counted
    suppression.  Returns the path's K1 launches."""
    from keystone_tpu_torch.core.lifecycle import (
        LifecycleConfig, LifecycleController, featurized_training_set)
    from keystone_tpu_torch.workloads.fv_common import (
        stream_config_from_flags, stream_features_snapshot)

    t_phase = time.perf_counter()
    servable, tar, conf22 = snap24["servable"], str(c22["tar"]), c22["conf"]
    conv, scaler = Pipeline([servable.nodes[0]]), servable.nodes[1]
    dev = servable.nodes[0].device
    chunk = conf22.featurize_chunk
    decode_mode = stream_config_from_flags(device_decode=conf22.device_decode).decode_mode
    key24 = ksnap.snapshot_key(tar, batch_size=chunk, mode="featurized",
                               featurizer=ksnap.featurizer_digest(conv),
                               extra=f"decode_mode={decode_mode}")
    to_labels = ClassLabelIndicatorsFromIntLabels(N_CLASSES)

    def no_stream():
        raise AssertionError("phase 24's featurized snapshot missed: the refit would decode")

    def from_phase24():
        feats, names, stats = stream_features_snapshot(
            no_stream, None, root=str(snap24["feat_root"]), key=key24, tar_path=tar)
        labels = to_labels(torch.as_tensor([cifar.cifar_tar_label(n) for n in names]))
        return feats, labels, stats

    lc_root = str(data_dir / "lifecycle_refit_snapshots")
    infos = []

    def fetch(digest):
        """The refit's training set; records its source and the K1 launches
        fetching it made (a featurizer recompute would launch K1)."""
        k1 = rp.fused_launches
        feats, labels, info = featurized_training_set(
            lc_root, tar_path=tar, featurizer=conv, batch_size=chunk,
            extra="lifecycle_refit", compute=lambda: from_phase24()[:2])
        infos.append({**{k: info[k] for k in ("source", "stale", "digest")},
                      "conv_rect_pool_launches": rp.fused_launches - k1})
        return scaler(torch.from_numpy(feats).to(dev)), torch.from_numpy(labels).to(dev)

    # The refit training set, committed once from phase 24's snapshot.
    rp.launches = rp.fused_launches = 0
    _, _, seed_stats = from_phase24()
    fetch(None)
    if rp.fused_launches or infos[0]["source"] != "computed" or \
            seed_stats.snapshot_chunks_read != math.ceil(CIFAR_TAR_TEST / chunk):
        raise AssertionError(f"refit set seed: K1 {rp.fused_launches}, {infos}, {seed_stats}")

    # The offline refit oracle on the same data.
    feats, labels = fetch(None)
    offline_model = BlockLeastSquaresEstimator(4096, 1, conf22.lam).fit(feats, labels)
    offline = Pipeline([*conv.nodes, scaler, offline_model, MaxClassifier()])
    del feats, labels

    # The incumbent: phase 22's chain, its baseline the sketch of phase 24's
    # test predictions, served at the default buckets.
    rng = np.random.default_rng(28)
    palette22 = np.random.default_rng(22).uniform(40, 215, (N_CLASSES, 3))
    stem = str(data_dir / "lifecycle_incumbent")
    save_pipeline(stem, servable, numerics_baseline=knum.OutputSketch.for_outputs(
        snap24["predictions"]).record())
    pool = cifar48_split(16 * LIFECYCLE_SHIFTED, rng, palette22)
    shifted = np.asarray(pool.images[pool.labels == 0][:LIFECYCLE_SHIFTED], np.float32)
    holdout = cifar48_split(LIFECYCLE_HOLDOUT, rng, palette22)
    example = np.empty(shifted.shape[1:], np.float32)

    def quality(predict, x, y):
        return float(np.mean(np.asarray(predict(x)) == y))

    rp.launches = rp.fused_launches = 0
    resilience.counters.reset()
    engines = []
    with knum.monitored(True), kfrontend.ShapeRouter(label="lifecycle") as router:
        incumbent, inc_cold = kserve.load_engine(stem, example, label="cifar48_incumbent",
                                                 device=dev)
        engines.append(incumbent)
        router.add_engine(incumbent)
        inc_off = incumbent.offline(shifted)
        new_off = offline(torch.from_numpy(shifted).to(dev)).cpu().numpy()
        answers, errors, stop = [], [], threading.Event()

        def traffic():
            try:
                i = 0
                while not stop.is_set():
                    futs = [(j % len(shifted), router.submit(shifted[j % len(shifted)]))
                            for j in range(i, i + 16)]
                    answers.extend((j, f.result(60.0)) for j, f in futs)
                    i += 16
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        with LifecycleController(
            router, workdir=str(data_dir / "lifecycle_wd"), featurizer=conv, fetch=fetch,
            estimator=lambda: BlockLeastSquaresEstimator(4096, 1, conf22.lam),
            assemble=lambda model: Pipeline([*conv.nodes, scaler, model, MaxClassifier()]),
            holdout=lambda: (holdout.images, holdout.labels), quality=quality,
            example=example, label="cifar48",
            config=LifecycleConfig(cooldown_s=300.0, poll_interval_s=0.05,
                                   quality_margin=LIFECYCLE_MARGIN),
        ) as ctl:
            t = threading.Thread(target=traffic)
            t.start()
            ctl.start()
            deadline = time.monotonic() + 300.0
            while ctl.record()["last_cycle"] is None and time.monotonic() < deadline:
                time.sleep(0.05)
            cycle = dict(ctl.record()["last_cycle"] or {})
            # The swapped engine judges the same mix against the
            # candidate's balanced holdout sketch: a second trip.
            while resilience.counters.get("refit_suppressed") < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            stop.set()
            t.join(120.0)
            second = ctl.record()["last_cycle"]
            post_engine = router.server_for(example.shape).engine
            engines.append(post_engine)
            post = np.stack([f.result(60.0) for f in [router.submit(r) for r in shifted]])
    events = resilience.counters.snapshot()
    graph = {}
    for eng in engines:
        add_launches(graph, eng.graph_launches())
    k1 = rp.fused_launches + graph.get("conv_rect_pool", 0)
    ok_answers = all(np.array_equal(a, inc_off[j]) or np.array_equal(a, new_off[j])
                     for j, a in answers)
    rec = {"phase": "28(f): drift -> warm refit -> validate -> hot-swap", "card": card,
           "cycle": {k: cycle.get(k) for k in (
               "outcome", "reason", "generation", "cold_fit", "quality", "refit_wall_s",
               "validate_wall_s", "swap_wall_s", "total_wall_s", "cold_start", "engine_label")},
           "refit_training_set": infos[-1],
           "incumbent_cold_start": inc_cold, "second_trip": second,
           "requests_answered_during_cycle": len(answers), "request_errors": len(errors),
           "answers_from_either_model": ok_answers,
           "post_swap_equal_offline_refit": bool(np.array_equal(post, new_off)),
           "post_swap_buckets": list(post_engine.buckets()),
           "post_swap_graphs": sorted(b for b, g in post_engine._exec.items()
                                      if isinstance(g, kserve._GraphBucket)),
           "events": events, "conv_rect_pool_launches": {
               "eager": rp.fused_launches, "graph_replays": graph.get("conv_rect_pool", 0)},
           "seconds": time.perf_counter() - t_phase}
    log(json.dumps(rec))
    if not (cycle.get("outcome") == "swapped" and cycle.get("reason") == "serve_output_drift"
            and infos[-1]["source"] == "snapshot" and infos[-1]["conv_rect_pool_launches"] == 0
            and not errors and ok_answers and rec["post_swap_equal_offline_refit"]
            and post_engine is not incumbent and rec["post_swap_graphs"]
            and events.get("lifecycle_refit") == 1 and events.get("refit_suppressed", 0) >= 1
            and second["outcome"] == "suppressed" and not rp.launches and k1):
        raise AssertionError(f"lifecycle: {rec}")
    return {"conv_rect_pool": k1}


def mesh_tiers(fit_report: dict) -> dict:
    """Each considered tier's plan (admitted, per-slot budget and charge,
    GB) and, where it ran, its wall seconds, from a fit's report."""
    walls = {c["name"]: c["measured_seconds"]
             for c in (fit_report.get("placement") or {}).get("candidates", [])}
    return {name: {"admitted": t["admitted"], "budget_gb": t["budget_gb"],
                   "total_gb": t["total_gb"], "wall_seconds": walls.get(name)}
            for name, t in fit_report["tiers"].items()}


def run_mesh(card: str, fitted: dict, timit12: dict) -> dict:
    """Phase 29: the single-process mesh on eight slots of the one card.
    Returns the K1 launches of its runs through the entry points ((b) with
    ``--mesh 1`` and (c)); (a)'s featurize comparisons are not counted."""
    t_phase = time.perf_counter()
    rec: dict = {"phase": "29: the single-process mesh", "card": card}
    slots = [torch.device("cuda", 0)] * 8
    meshes = {"4x2": make_mesh(4, 2, devices=slots), "8x1": make_mesh(8, 1, devices=slots)}
    conf = cifar.RandomCifarConfig(lam=10.0, device="cuda")  # MAIN_FLAGS' values
    train, test = cifar_loader(str(fitted["cifar_train"])), cifar_loader(str(fitted["cifar_test"]))
    chunk = conf.featurize_chunk

    def per_slot_chunks(n: int, data: int) -> int:
        return math.ceil(math.ceil(n / data) / math.ceil(chunk / data))

    # (a) the featurize, unsharded and row-sharded, on one fitted featurizer.
    torch.cuda.empty_cache()
    conv = cifar.build_conv_pipeline(conf, *cifar.learn_filters(conf, train.images))
    whole = cifar.featurize_chunked(conv, train.images, chunk, "cuda")
    rec["featurize"] = {}
    for name, mesh in meshes.items():
        rp.fused_launches = 0
        t = time.perf_counter()
        sharded = cifar.featurize_chunked(conv, train.images, chunk, "cuda", mesh=mesh)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        data = mesh.shape["data"]
        # The model slots of a data block share the card, so its rows and results.
        want = data * per_slot_chunks(N_TRAIN, data)
        rows = sharded.gather()
        rec["featurize"][name] = {
            "seconds": secs, "conv_rect_pool_launches": rp.fused_launches,
            "expected_launches": want, "bit_equal": bool(torch.equal(rows, whole)),
            "max_rel_err": rel_err(rows, whole)}
        if rp.fused_launches != want or not (rec["featurize"][name]["bit_equal"]
                                             or rec["featurize"][name]["max_rel_err"] <= 1e-2):
            raise AssertionError(f"mesh featurize {name}: {rec['featurize'][name]}")
        del sharded, rows
    del whole, conv
    log(json.dumps({"phase": "29(a)", "card": card, **rec["featurize"]}))
    rp.launches = 0

    # (b) the CLI without a mesh and with --mesh 1.
    argv = ["--trainLocation", str(fitted["cifar_train"]), "--testLocation",
            str(fitted["cifar_test"]), *MAIN_FLAGS]
    torch.cuda.empty_cache()
    plain = cifar.main(argv)
    rp.fused_launches = 0
    one = cifar.main([*argv, "--mesh", "1"])
    launches = rp.fused_launches
    m0, m1 = plain["servable"].nodes[-2], one["servable"].nodes[-2]
    rec["mesh_1"] = {
        "chosen": one["fit_report"]["chosen_tier"], "conv_rect_pool_launches": launches,
        "model_equal": all(torch.equal(a, b) for a, b in zip([*m0.xs, m0.b], [*m1.xs, m1.b])),
        "predictions_equal": bool(np.array_equal(one["test_predictions"],
                                                 plain["test_predictions"])),
        "predictions_equal_phase3": bool(np.array_equal(plain["test_predictions"],
                                                        fitted["cifar_pred"])),
        "seconds": one["seconds"], "plain_seconds": plain["seconds"]}
    log(json.dumps({"phase": "29(b)", "card": card, **rec["mesh_1"]}))
    if not (rec["mesh_1"]["model_equal"] and rec["mesh_1"]["predictions_equal"]
            and rec["mesh_1"]["predictions_equal_phase3"]
            and rec["mesh_1"]["chosen"] == "fused[mesh 1x1]"
            and launches == 1 + per_slot_chunks(N_TRAIN, 1) + per_slot_chunks(N_TEST, 1)):
        raise AssertionError(f"--mesh 1: {rec['mesh_1']}")
    del one, m0, m1

    # (c) the fit on both meshes of the card's eight slots.
    rec["runs"] = {}
    kept = {}
    for name, mesh in meshes.items():
        torch.cuda.empty_cache()
        rp.fused_launches = 0
        with SolvePeak() as fits:
            res = cifar.run(conf, train, test, mesh=mesh)
        launches += rp.fused_launches
        data = mesh.shape["data"]
        want = data * (1 + per_slot_chunks(N_TRAIN, data) + per_slot_chunks(N_TEST, data))
        flips = int((res["test_predictions"] != plain["test_predictions"]).sum())
        rec["runs"][name] = {
            "conv_rect_pool_launches": rp.fused_launches, "expected_launches": want,
            "train_error": res["train_error"], "test_error": res["test_error"],
            "single_train_error": plain["train_error"], "single_test_error": plain["test_error"],
            "test_predictions_differing": flips,
            "chosen": res["fit_report"]["chosen_tier"],
            "mesh_shape": res["fit_report"]["mesh_shape"],
            "search_seconds": res["placement"]["search_seconds"],
            "ranking": res["placement"]["ranking"], "tiers": mesh_tiers(res["fit_report"]),
            "solve_peak_gb": fits[0]["peak_memory_gb"], "fit_seconds": fits[0]["seconds"],
            "featurize_seconds": res["featurize_seconds"],
            "solve_seconds": res["solve_seconds"], "seconds": res["seconds"]}
        log(json.dumps({"phase": f"29(c) {name}", "card": card, **rec["runs"][name]}))
        r = rec["runs"][name]
        if not (r["conv_rect_pool_launches"] == want
                and abs(r["train_error"] - plain["train_error"]) < 0.6
                and abs(r["test_error"] - plain["test_error"]) < 1.1
                and r["chosen"] == f"fused[mesh {name}]"):
            raise AssertionError(f"Cifar on mesh {name}: {r}")
        if name == "4x2":
            # Phase 32 holds its --autoCache run to this one.
            model = res["servable"].nodes[-2]
            kept = {"predictions": res["test_predictions"],
                    "model": [t.cpu() for t in (*model.xs, model.b)]}
        del res
    del plain

    # (d) a mesh larger than the card count.
    try:
        cifar.main([*argv, "--mesh", "2"])
    except ValueError as e:
        rec["mesh_2"] = str(e)
    if rec.get("mesh_2") != f"mesh 2x1 needs 2 devices, have {torch.cuda.device_count()}":
        raise AssertionError(f"--mesh 2 on {torch.cuda.device_count()} card(s): {rec.get('mesh_2')}")

    # (e) TIMIT config 4 over eight slots of the card.
    torch.cuda.empty_cache()
    total = torch.cuda.mem_get_info()[1]
    with SolvePeak() as fits:
        res = timit.run(timit.TimitConfig(device="cuda"), timit12["data"],
                        mesh=meshes["8x1"])
    tiers = mesh_tiers(res["fit_report"])
    mesh_plans = {k: v for k, v in tiers.items() if k.startswith("fused[mesh")}
    rec["timit"] = {
        "chosen": res["fit_report"]["chosen_tier"], "tiers": tiers,
        "card_gb": total / 2**30, "search_seconds": res["fit_report"]["placement"]["search_seconds"],
        "solve_peak_gb": fits[0]["peak_memory_gb"], "fit_seconds": fits[0]["seconds"],
        "test_error": res["test_error"], "phase12_test_error": timit12["test_error"],
        "seconds": res["seconds"]}
    log(json.dumps({"phase": "29(e)", "card": card, **rec["timit"]}))
    del res
    torch.cuda.empty_cache()
    if not (mesh_plans and all(v["budget_gb"] is not None
                               and v["budget_gb"] * 8 <= total / 2**30
                               for v in mesh_plans.values())
            and abs(rec["timit"]["test_error"] - timit12["test_error"]) < 1.0):
        raise AssertionError(f"TIMIT on eight slots: {rec['timit']}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 29: {rec['seconds']:.2f} s")
    return {"conv_rect_pool": launches, "cifar_4x2": kept}


# Phase 30: the (e) part's small CLI inputs (images per split of phase 6's
# VOC images; ImageNet classes and images per class; Newsgroups documents
# per class).
MESH_CLI_VOC = 48
MESH_CLI_INET_CLASSES, MESH_CLI_INET_PER_CLASS = 10, (4, 2)
MESH_CLI_NG_PER_CLASS = (20, 10)


class K2Calls:
    """The ``[n, d, cols]`` shape of each fv_stats call while active (it
    wraps the entry ``ops.fisher`` calls), with the launches each reckons
    from ``fv_stats.launch_geometry``."""

    def __enter__(self) -> list:
        self.calls = []
        self._orig = orig = fisher_mod.fv_stats

        def counted(x, counts, means, variances, weights):
            self.calls.append((*x.shape, int(weights.shape[0])))
            return orig(x, counts, means, variances, weights)

        fisher_mod.fv_stats = counted
        return self.calls

    def __exit__(self, *exc) -> None:
        fisher_mod.fv_stats = self._orig


def reckoned_launches(calls: list) -> int:
    return sum(math.ceil(n / fs.launch_geometry(n, d, cols, k).group)
               for n, d, cols, k in calls)


def slot_rows(sizes, data: int) -> int:
    """Rows the data slots hold for buckets of ``sizes`` images: each slot
    ``ceil(n / data)``, pad images included."""
    return sum(data * math.ceil(n / data) for n in sizes)


def bucket_sizes(images: list) -> list:
    counts: dict = {}
    for img in images:
        counts[img.shape[:2]] = counts.get(img.shape[:2], 0) + 1
    return list(counts.values())


def sharded_equal(sharded, whole: torch.Tensor) -> bool:
    """Are a ``ShardedRows``' true rows ``torch.equal`` to ``whole``,
    compared data block by data block (no gathered copy)?"""
    out, start = True, 0
    for block in sharded.data_blocks():
        rows = max(0, min(int(block.shape[0]), sharded.nvalid - start))
        out = out and torch.equal(block[:rows], whole[start : start + rows])
        start += int(block.shape[0])
    return out and start >= whole.shape[0]


def scores_vs(got: np.ndarray, want: np.ndarray) -> dict:
    return {"bit_equal": bool(np.array_equal(got, want)),
            "max_abs_err": float(np.abs(got - want).max()),
            "max_abs": float(np.abs(want).max())}


def run_mesh_fv(card: str, data_dir: Path, fitted: dict, phase6: dict, inet17: dict,
                bwls26: dict) -> dict:
    """Phase 30: VOCSIFTFisher, ImageNetSiftLcsFV, the class-weighted solve
    and NewsgroupsPipeline on eight slots of the card, then the three CLIs
    with ``--mesh 1`` and ``--mesh 2``.  Returns the K2 launches of its
    runs through the entry points."""
    t_phase = time.perf_counter()
    slots = [torch.device("cuda", 0)] * 8
    meshes = {"8x1": make_mesh(8, 1, devices=slots), "4x2": make_mesh(4, 2, devices=slots)}
    launches = 0
    rec: dict = {"phase": "30: the FV and text pipelines on the mesh", "card": card}

    # (a) VOCSIFTFisher at phase 6's configuration and images.
    conf = voc.SIFTFisherConfig(**VOC_CONF)
    train, test = phase6["train"], phase6["test"]
    bundle = load_pipeline(str(fitted["voc_stem"]), device="cuda")
    featurize = Pipeline([bundle["pca"], fisher_feature_pipeline(bundle["gmm"])])
    feat_dim = 2 * conf.desc_dim * conf.vocab_size
    torch.cuda.empty_cache()
    whole_desc = voc.extract_sift_buckets(conf, test.images)
    whole_feats = scatter_features(whole_desc, featurize, len(test), feat_dim)
    rec["voc"] = {}
    compared = {}
    for name, mesh in meshes.items():
        desc = voc.extract_sift_buckets(conf, test.images, mesh)
        feats = scatter_features(desc, featurize, len(test), feat_dim)
        compared[name] = {
            "descriptors_equal": all(sharded_equal(desc[shape][1], whole_desc[shape][1])
                                     for shape in whole_desc),
            "features_equal": bool(torch.equal(feats, whole_feats)),
            "features_max_abs_err": float((feats - whole_feats).abs().max()),
            "features_max_abs": float(whole_feats.abs().max())}
        del desc, feats
    del whole_desc, whole_feats, bundle, featurize
    voc_scores = {}
    for name, mesh in meshes.items():
        data = mesh.shape["data"]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fs.launches = 0
        with K2Calls() as calls:
            t = time.perf_counter()
            res = voc.run(conf, train, test, mesh=mesh)
            secs = time.perf_counter() - t
        launches += fs.launches
        voc_scores[name] = res["test_scores"]
        want_rows = slot_rows(bucket_sizes(train.images), data) + slot_rows(
            bucket_sizes(test.images), data)
        r = rec["voc"][name] = {
            "fv_stats_launches": fs.launches, "reckoned_launches": reckoned_launches(calls),
            "fv_stats_calls": len(calls), "fv_stats_rows": sum(c[0] for c in calls),
            "slot_rows": want_rows, **compared[name],
            "scores": scores_vs(res["test_scores"], phase6["scores"]),
            "map": res["map"], "phase6_map": phase6["map"],
            "featurize_placement": res["placement"]["featurize"]["chosen"],
            "solve_tier": res["fit_report"]["chosen_tier"],
            "seconds": secs, "phase6_seconds": fitted["voc_seconds"],
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(json.dumps({"phase": f"30(a) VOC {name}", "card": card, **r}))
        del res
        sc = r["scores"]
        if not (r["fv_stats_launches"] == r["reckoned_launches"]
                and r["fv_stats_calls"] == 2 * len(VOC_SHAPES) * data
                and r["fv_stats_rows"] == want_rows and r["descriptors_equal"]
                and (r["features_equal"]
                     or r["features_max_abs_err"] <= 1e-5 * r["features_max_abs"])
                and (sc["bit_equal"] or sc["max_abs_err"] <= 1e-5 * sc["max_abs"])
                and r["map"] == phase6["map"]):
            raise AssertionError(f"VOC on mesh {name}: {r}")
    torch.cuda.empty_cache()
    # K2 at one data slot's shard of the 375x500 bucket, on each mesh.
    gen = torch.Generator(device="cuda").manual_seed(30)
    per = VOC_SHAPES[(375, 500)]
    rec["fv_stats_slot"] = {
        name: time_fv_stats(math.ceil(per / mesh.shape["data"]), gen, plain=name == "8x1")
        for name, mesh in meshes.items()}
    torch.cuda.empty_cache()

    # (b) ImageNetSiftLcsFV at phase 17's configuration and images on 4x2.
    iconf = inet.ImageNetSiftLcsFVConfig(num_classes=IMAGENET_CLASSES, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    fs.launches = 0
    with K2Calls() as calls:
        t = time.perf_counter()
        res = inet.run(iconf, inet17["train"], inet17["test"], mesh=meshes["4x2"])
        secs = time.perf_counter() - t
    launches += fs.launches
    data = meshes["4x2"].shape["data"]
    want_rows = len(inet.BRANCHES) * (slot_rows(bucket_sizes(inet17["train"].images), data)
                                      + slot_rows(bucket_sizes(inet17["test"].images), data))
    tiers = mesh_tiers(res["fit_report"])
    r = rec["imagenet"] = {
        "fv_stats_launches": fs.launches, "reckoned_launches": reckoned_launches(calls),
        "fv_stats_rows": sum(c[0] for c in calls), "slot_rows": want_rows,
        "bwls_tiers": tiers, "solve_tier": res["fit_report"]["chosen_tier"],
        "featurize_placements": {k: v["chosen"] for k, v in res["placement"].items()
                                 if k.startswith("featurize")},
        "top1_err_percent": res["top1_err_percent"],
        "top5_err_percent": res["top5_err_percent"],
        "phase17_top1": inet17["top1_err_percent"], "phase17_top5": inet17["top5_err_percent"],
        "scores": scores_vs(res["test_scores"], inet17["scores"]),
        "seconds": secs, "phase17_seconds": inet17["seconds"],
        "solve_seconds": res["solve_seconds"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(json.dumps({"phase": "30(b) ImageNet 4x2", "card": card, **r}))
    got, want = res["test_scores"], inet17["scores"]
    del res
    torch.cuda.empty_cache()
    if not (r["fv_stats_launches"] == r["reckoned_launches"] and r["fv_stats_rows"] == want_rows
            and r["top1_err_percent"] == r["phase17_top1"]
            and r["top5_err_percent"] == r["phase17_top5"]
            and np.allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max())):
        raise AssertionError(f"ImageNet on mesh 4x2: {r}")

    # (c) Phase 26(d)'s class-weighted solve, its inputs row-sharded.
    inet_conf = inet.ImageNetSiftLcsFVConfig()
    labels = np.random.default_rng(29).permutation(
        np.repeat(np.arange(IMAGENET_CLASSES), BWLS_ROWS // IMAGENET_CLASSES))
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn((BWLS_ROWS, BWLS_WIDTH), generator=gen, device="cuda")
    y = torch.as_tensor(2.0 * np.eye(IMAGENET_CLASSES, dtype=np.float32)[labels] - 1.0,
                        device="cuda")
    want_w, want_b = bwls26["weights"].cuda(), bwls26["b"].cuda()
    # The same fit in f64: the yardstick both f32 fits are held to.  A
    # data axis adds the row sums in another order, and at lambda 6e-5 the
    # f32 solve carries that difference to about 1e-4 of the weights.
    exact = BlockWeightedLeastSquaresEstimator(BWLS_BLOCK, 1, inet_conf.lam,
                                               inet_conf.mixture_weight).fit(
        x.double(), y.double(), plan=False)
    exact_w, exact_b = torch.cat(exact.xs), exact.b
    del exact

    def f64_err(w, b) -> float:
        return max(float((w.double() - exact_w).abs().max() / exact_w.abs().max()),
                   float((b.double() - exact_b).abs().max() / exact_b.abs().max()))

    fused_err = f64_err(want_w, want_b)
    rec["bwls"] = {}
    for name in ("4x2", "8x1"):
        mesh = meshes[name]
        xs, ys = padded_shard_rows(x, mesh)[0], padded_shard_rows(y, mesh)[0]
        est = BlockWeightedLeastSquaresEstimator(BWLS_BLOCK, 1, inet_conf.lam,
                                                 inet_conf.mixture_weight, mesh=mesh)
        ctx = weighted_mod._SolveCtx.of(labels, IMAGENET_CLASSES, torch.float32,
                                        inet_conf.mixture_weight, est.class_chunk, "cpu",
                                        data=mesh.shape["data"], model=mesh.shape["model"])
        plan = weighted_mod._RegroupPlan(ctx.order, xs.rows, ctx.p_tot, mesh.shape["data"])
        torch.cuda.synchronize()
        t = time.perf_counter()
        # The hand ladder: the mesh asked for runs (the search ranks meshes
        # without a data axis first, which skip the regroup).
        model = est.fit(xs, ys, plan=False)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        weights = torch.cat(model.xs)
        r = rec["bwls"][name] = {
            "regroup_usable": plan.usable, "m_pad": plan.m_pad, "rows_out": plan.rows_out,
            "chosen": est.last_fit_report.chosen,
            "tiers": mesh_tiers(est.last_fit_report.record()),
            "max_abs_err_weights": float((weights - want_w).abs().max()),
            "max_abs_err_intercept": float((model.b - want_b).abs().max()),
            "max_abs_weights": float(want_w.abs().max()),
            "within_rtol_1e-4_of_fused": bool(
                torch.allclose(weights, want_w, rtol=1e-4, atol=1e-5 * float(want_w.abs().max()))
                and torch.allclose(model.b, want_b, rtol=1e-4,
                                   atol=1e-5 * float(want_b.abs().max()))),
            "rel_err_vs_f64": f64_err(weights, model.b), "fused_rel_err_vs_f64": fused_err,
            "seconds": secs, "phase26_fused_seconds": bwls26["seconds"]}
        log(json.dumps({"phase": f"30(c) weighted solve {name}", "card": card, **r}))
        # No further from the f64 fit than twice the fused fit's distance
        # (plus 1e-5 of the largest weight).
        if not (r["chosen"] == f"fused[mesh {name}]" and r["regroup_usable"]
                and r["rel_err_vs_f64"] <= 2 * fused_err + 1e-5):
            raise AssertionError(f"weighted solve on mesh {name}: {r}")
        del xs, ys, model, weights
    del x, y, want_w, want_b, exact_w, exact_b
    torch.cuda.empty_cache()

    # (d) NewsgroupsPipeline over eight data slots against the same run
    # without a mesh, on (e)'s small corpus: the full corpus's host text
    # pass is phase 15's, and a second one here cost about 30 s.
    cli_root = data_dir / "mesh_cli"
    ng_root = cli_root / "newsgroups"
    ngrng = np.random.default_rng(37)
    for split, per in zip(("train", "test"), MESH_CLI_NG_PER_CLASS):
        write_newsgroups_tree(ng_root / split, NG_CLASSES, [per] * 20, ngrng)
    before = kernel_launches()
    ngconf = newsgroups.NewsgroupsConfig(n_grams=2, common_features=100_000, device="cuda")
    ngtrain = newsgroups_loader(str(ng_root / "train"))
    ngtest = newsgroups_loader(str(ng_root / "test"))
    plain = newsgroups.run(ngconf, ngtrain, ngtest)
    res = newsgroups.run(ngconf, ngtrain, ngtest, mesh=meshes["8x1"])
    r = rec["newsgroups"] = {
        "documents": [len(ngtrain.data), len(ngtest.data)],
        "scores_equal": bool(np.array_equal(res["test_scores"], plain["test_scores"])),
        "test_error": res["test_error"], "unsharded_test_error": plain["test_error"],
        "score_seconds": res["score_seconds"], "seconds": res["seconds"],
        "unsharded_seconds": plain["seconds"], "kernel_launches_after": kernel_launches()}
    log(json.dumps({"phase": "30(d) Newsgroups 8x1", "card": card, **r}))
    if not (r["scores_equal"] and r["test_error"] == plain["test_error"]
            and kernel_launches() == before):
        raise AssertionError(f"Newsgroups on mesh 8x1: {r} (launches before {before})")
    del plain, res, ngtrain, ngtest

    # (e) The three CLIs on small inputs, without a mesh and with --mesh 1.
    (cli_root / "voc").mkdir(parents=True)
    n = MESH_CLI_VOC
    write_voc_tars(cli_root / "voc", {
        "train": MultiLabeledImages(train.images[:n], train.labels[:n], train.filenames[:n]),
        "test": MultiLabeledImages(test.images[:n], test.labels[:n], test.filenames[:n])})
    inet_root = cli_root / "imagenet"
    inet_root.mkdir()
    splits = {}
    for seed, (split, per) in enumerate(zip(("train", "test"), MESH_CLI_INET_PER_CLASS)):
        lab = np.repeat(np.arange(MESH_CLI_INET_CLASSES), per)
        shapes = [IMAGENET_SHAPES[i % 2] for i in range(len(lab))]
        splits[split] = LabeledImages(imagenet_images(31 + seed, lab, shapes),
                                      lab.astype(np.int32), [str(i) for i in range(len(lab))])
    write_imagenet_tars(inet_root, splits)
    clis = {
        "voc": (voc.main, ["--trainLocation", str(cli_root / "voc" / "train.tar"),
                           "--testLocation", str(cli_root / "voc" / "test.tar"),
                           "--labelPath", str(cli_root / "voc" / "labels.csv"),
                           "--device", "cuda"]),
        "imagenet": (inet.main, ["--trainLocation", str(inet_root / "train"),
                                 "--testLocation", str(inet_root / "test"),
                                 "--labelPath", str(inet_root / "labels.txt"),
                                 "--numClasses", str(MESH_CLI_INET_CLASSES),
                                 "--device", "cuda"]),
        "newsgroups": (newsgroups.main, ["--trainLocation", str(ng_root / "train"),
                                         "--testLocation", str(ng_root / "test"),
                                         *NG_FLAGS]),
    }
    rec["cli"] = {}
    for name, (main_fn, argv) in clis.items():
        plain = main_fn(argv)
        fs.launches = 0
        one = main_fn([*argv, "--mesh", "1"])
        launches += fs.launches
        try:
            main_fn([*argv, "--mesh", "2"])
            mesh_2 = None
        except ValueError as e:
            mesh_2 = str(e)
        r = rec["cli"][name] = {
            "scores_equal": bool(np.array_equal(one["test_scores"], plain["test_scores"])),
            "fv_stats_launches_mesh_1": fs.launches, "mesh_2": mesh_2,
            "seconds_mesh_1": one["seconds"], "seconds": plain["seconds"]}
        log(json.dumps({"phase": f"30(e) {name} CLI --mesh 1", "card": card, **r}))
        if not (r["scores_equal"] and mesh_2 == "mesh 2x1 needs 2 devices, have "
                f"{torch.cuda.device_count()}" and (name == "newsgroups") == (fs.launches == 0)):
            raise AssertionError(f"{name} CLI with --mesh: {r}")
        del plain, one
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 30: {rec['seconds']:.2f} s")
    return {"fv_stats": launches, "fv_stats_slot": rec["fv_stats_slot"],
            "voc_8x1_scores": voc_scores["8x1"]}


class FitInputs:
    """The ``(features, labels)`` of each ``BlockLeastSquaresEstimator.fit``
    while active."""

    def __enter__(self) -> list:
        self.calls = []
        self._orig = orig = BlockLeastSquaresEstimator.fit

        def fit(est, features, labels, *args, **kw):
            self.calls.append((features, labels))
            return orig(est, features, labels, *args, **kw)

        BlockLeastSquaresEstimator.fit = fit
        return self.calls

    def __exit__(self, *exc) -> None:
        BlockLeastSquaresEstimator.fit = self._orig


def spec_row(fit_report: dict, name: str, wall: float) -> dict:
    """One candidate run forced to the head: the tier that ran, its
    per-slot charge against the slot budget (GB), the wall (host clock
    after a synchronize) and the prior's predicted seconds."""
    cand = next(c for c in fit_report["placement"]["candidates"] if c["name"] == name)
    tier = fit_report["tiers"].get(name, {})
    return {"chosen": fit_report["chosen_tier"], "outcome": cand["outcome"],
            "specs": cand["specs"], "charge_gb": tier.get("total_gb"),
            "budget_gb": tier.get("budget_gb"), "wall_seconds": wall,
            "predicted_seconds": cand["predicted_seconds"]}


def same_model(a, b) -> bool:
    return torch.equal(a.b, b.b) and all(torch.equal(p, q) for p, q in zip(a.xs, b.xs))


def time_every_candidate(label: str, make, x, y, placement: dict) -> dict:
    """Each candidate of ``placement``'s ranking run once: a mesh candidate
    forced to the head (``make(mesh).fit(x, y, plan=[name])``), its
    :func:`spec_row`, and for a spec candidate whether its model is
    ``torch.equal`` to the default layout's on the same mesh shape (the
    defaults rank first).  A forced ranking keeps the floor last, so the
    floor is timed as what it runs: the hand ladder without a mesh on the
    rows gathered to one device."""
    rows, models = {}, {}
    for name in placement["ranking"]:
        torch.cuda.empty_cache()
        floor = name == "single_device"
        est = make(not floor)
        torch.cuda.synchronize()
        t = time.perf_counter()
        model = (est.fit(unshard(x), unshard(y), plan=False) if floor
                 else est.fit(x, y, plan=[name]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        if floor:
            rep = est.last_fit_report.record()
            cand = next(c for c in placement["candidates"] if c["name"] == name)
            tier = rep["tiers"][rep["chosen_tier"]]
            row = rows[name] = {
                "chosen": f"single_device/{rep['chosen_tier']}", "outcome": "ok", "specs": None,
                "charge_gb": tier["total_gb"], "budget_gb": tier["budget_gb"],
                "wall_seconds": wall, "predicted_seconds": cand["predicted_seconds"]}
        else:
            row = rows[name] = spec_row(est.last_fit_report.record(), name, wall)
        if row["specs"]:
            row["equal_default"] = same_model(model, models[name.split("|")[0] + "]"])
        else:
            models[name] = model
        if row["chosen"].split("/")[0] != name or row["outcome"] != "ok" or (
                row["specs"] and not row["equal_default"]):
            raise AssertionError(f"{label} candidate {name}: {row}")
    return rows


def run_mesh_specs(card: str, fitted: dict) -> dict:
    """Phase 31: the spec layouts of the mesh tiers on eight slots of the
    card.  Returns the K1 launches of its Cifar runs."""
    t_phase = time.perf_counter()
    mesh = make_mesh(4, 2, devices=[torch.device("cuda", 0)] * 8)
    on_mesh = {"data": 4, "model": 2}
    rec: dict = {"phase": "31: spec layouts of the mesh tiers", "card": card}
    conf = cifar.RandomCifarConfig(lam=10.0, device="cuda")  # MAIN_FLAGS' values
    train, test = cifar_loader(str(fitted["cifar_train"])), cifar_loader(str(fitted["cifar_test"]))
    per = math.ceil(conf.featurize_chunk / 4)
    want = 4 * (1 + math.ceil(math.ceil(N_TRAIN / 4) / per) + math.ceil(math.ceil(N_TEST / 4) / per))

    # (a) Cifar through cifar.run: the default layout, then each spec
    # candidate of the 4x2 head forced through conf.solve_plan.
    torch.cuda.empty_cache()
    rp.fused_launches = 0
    with FitInputs() as inputs, SolvePeak() as fits:
        base = cifar.run(conf, train, test, mesh=mesh)
    launches = rp.fused_launches
    placement = base["placement"]
    head = placement["ranking"][0]
    base_model = base["servable"].nodes[-2]
    rec["cifar"] = {head: {**spec_row(base["fit_report"], head, fits[0]["seconds"]),
                           "conv_rect_pool_launches": rp.fused_launches}}
    names = [c["name"] for c in placement["candidates"] if c["specs"] and c["mesh"] == on_mesh]
    for name in names:
        torch.cuda.empty_cache()
        rp.fused_launches = 0
        with SolvePeak() as fits:
            res = cifar.run(dataclasses.replace(conf, solve_plan=[name]), train, test, mesh=mesh)
        launches += rp.fused_launches
        rec["cifar"][name] = {
            **spec_row(res["fit_report"], name, fits[0]["seconds"]),
            "equal_default": same_model(res["servable"].nodes[-2], base_model),
            "predictions_equal": bool(np.array_equal(res["test_predictions"],
                                                     base["test_predictions"])),
            "conv_rect_pool_launches": rp.fused_launches}
        del res
    log(json.dumps({"phase": "31(a) Cifar on 4x2", "card": card, **rec["cifar"]}))
    rows = rec["cifar"]
    if not (head == "fused[mesh 4x2]" and len(names) == 3
            and all(r["chosen"] == n and r["outcome"] == "ok"
                    and r["conv_rect_pool_launches"] == want for n, r in rows.items())
            and all(rows[n]["equal_default"] and rows[n]["predictions_equal"] for n in names)):
        raise AssertionError(f"Cifar spec layouts on 4x2 (K1 {want} a run): {rows}")
    feats, labels = inputs[0]
    del base, base_model

    # (b) Every candidate of Cifar's searched solve once, on (a)'s inputs.
    def bcd(on_mesh: bool = True):
        return BlockLeastSquaresEstimator(4096, 1, conf.lam, mesh=mesh if on_mesh else None)

    rec["cifar_every"] = time_every_candidate("Cifar", bcd, feats, labels, placement)
    log(json.dumps({"phase": "31(b) every Cifar candidate", "card": card,
                    **rec["cifar_every"]}))

    # (c) Phase 26(d)'s class-weighted solve, row-sharded on 4x2: the
    # search, then every candidate once (each spec candidate against its
    # mesh's default layout).
    inet_conf = inet.ImageNetSiftLcsFVConfig()
    bwls_labels = np.random.default_rng(29).permutation(
        np.repeat(np.arange(IMAGENET_CLASSES), BWLS_ROWS // IMAGENET_CLASSES))
    gen = torch.Generator(device="cuda").manual_seed(29)
    x = torch.randn((BWLS_ROWS, BWLS_WIDTH), generator=gen, device="cuda")
    y = torch.as_tensor(2.0 * np.eye(IMAGENET_CLASSES, dtype=np.float32)[bwls_labels] - 1.0,
                        device="cuda")
    xs, ys = padded_shard_rows(x, mesh)[0], padded_shard_rows(y, mesh)[0]
    del x, y

    def bwls(on_mesh: bool = True):
        return BlockWeightedLeastSquaresEstimator(BWLS_BLOCK, 1, inet_conf.lam,
                                                  inet_conf.mixture_weight,
                                                  mesh=mesh if on_mesh else None)

    est = bwls()
    est.fit(xs, ys, plan=True)
    bwls_placement = est.last_fit_report.placement
    rec["bwls_searched"] = {"chosen": est.last_fit_report.chosen,
                            "ranking": bwls_placement["ranking"]}
    rec["bwls_every"] = time_every_candidate("BWLS", bwls, xs, ys, bwls_placement)
    log(json.dumps({"phase": "31(c) every BWLS candidate", "card": card,
                    "searched": rec["bwls_searched"], **rec["bwls_every"]}))
    spec_4x2 = [n for n, r in rec["bwls_every"].items()
                if r["specs"] and n.startswith("fused[mesh 4x2|")]
    if spec_4x2 != ["fused[mesh 4x2|labels=model@dim1]", "fused[mesh 4x2|labels=rep]"]:
        raise AssertionError(f"BWLS spec candidates on 4x2: {spec_4x2}")

    # (d) The same searches with KEYSTONE_AUTOSHARD_SPECS=0: no spec
    # candidate, the rest ranked as before.
    rec["specs_off"] = {}
    with env_set(KEYSTONE_AUTOSHARD_SPECS="0"):
        for label, make, x, y, on in (("cifar", bcd, feats, labels, placement),
                                      ("bwls", bwls, xs, ys, bwls_placement)):
            est = make()
            est.fit(x, y, plan=True)
            off = est.last_fit_report.placement
            rec["specs_off"][label] = {"ranking": off["ranking"], "chosen": off["chosen"]}
            kept = {c["name"] for c in off["candidates"]}
            if any(c["specs"] for c in off["candidates"]) or off["ranking"] != [
                    n for n in on["ranking"] if n in kept]:
                raise AssertionError(f"{label} with KEYSTONE_AUTOSHARD_SPECS=0: {off['ranking']}")
    log(json.dumps({"phase": "31(d) KEYSTONE_AUTOSHARD_SPECS=0", "card": card,
                    **rec["specs_off"]}))
    del feats, labels, xs, ys
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 31: {rec['seconds']:.2f} s")
    return {"conv_rect_pool": launches}


def slot_charge(plan: dict, data: int) -> dict:
    """A cache plan's per-slot charge: each decision's bytes over the data
    slots (what ``plan_caches(mesh=)`` admits) and the gate's allowance."""
    return {"budget_bytes": plan["budget_bytes"], "cached": plan["cached"],
            "per_slot_bytes": {d["name"]: d["output_bytes"] // data
                               for d in plan["decisions"]},
            "reasons": [d["reason"] for d in plan["decisions"]]}


def run_mesh_cache_ckpt(card: str, fitted: dict, phase6: dict, c22: dict, cifar29: dict,
                        voc30: np.ndarray) -> dict:
    """Phase 32: the auto-Cacher and the reshard checkpoint loader on slots
    of the card.  Each path runs with the kernel counts set to 0 just
    before it and read just after.  Returns the launches by kernel."""
    t_phase = time.perf_counter()
    slots = [torch.device("cuda", 0)] * 8
    m42, m81 = make_mesh(4, 2, devices=slots), make_mesh(8, 1, devices=slots)
    rec: dict = {"phase": "32: the auto-Cacher and the reshard loader on the mesh",
                 "card": card}
    total = {"conv_rect_pool": 0, "fv_stats": 0, "decode_pixels": 0}
    conf = cifar.RandomCifarConfig(lam=10.0, device="cuda")  # MAIN_FLAGS' values
    train = cifar_loader(str(fitted["cifar_train"]))
    test = cifar_loader(str(fitted["cifar_test"]))
    stem = fitted["cifar_stem"].parent / "cifar_mesh_servable"
    per = math.ceil(conf.featurize_chunk / 4)

    # (a) Cifar --autoCache --pipelineFile on 4x2: the plan's per-slot
    # charge, the model and predictions against phase 29's 4x2 run, then a
    # main call that restores the file.
    torch.cuda.empty_cache()
    rp.launches = rp.fused_launches = 0
    t = time.perf_counter()
    res = cifar.run(dataclasses.replace(conf, auto_cache=True, pipeline_file=str(stem)),
                    train, test, mesh=m42)
    secs = time.perf_counter() - t
    k1 = rp.fused_launches
    total["conv_rect_pool"] += k1
    # Per data slot: the warm chunk, the optimizer's four passes over its
    # one-chunk sample, the training split once (the fitted apply replays
    # the memo) and the test split.
    want = 4 * (1 + 4 + math.ceil(math.ceil(N_TRAIN / 4) / per)
                + math.ceil(math.ceil(N_TEST / 4) / per))
    model = res["servable"].nodes[-2]
    rec["cifar"] = {
        "plan": slot_charge(res["cache_plan"], 4), "conv_rect_pool_launches": k1,
        "expected_launches": want, "rect_pool_launches": rp.launches,
        "model_equal_phase29": all(torch.equal(a.cpu(), b) for a, b in
                                   zip((*model.xs, model.b), cifar29["model"])),
        "predictions_equal_phase29": bool(np.array_equal(res["test_predictions"],
                                                         cifar29["predictions"])),
        "test_error": res["test_error"], "featurize_seconds": res["featurize_seconds"],
        "seconds": secs}
    rp.fused_launches = 0
    t = time.perf_counter()
    back = cifar.main(["--trainLocation", str(fitted["cifar_train"]) + ".absent",
                       "--testLocation", str(fitted["cifar_test"]), *MAIN_FLAGS,
                       "--pipelineFile", str(stem), "--mesh", "1"])
    rec["cifar"]["restored"] = {
        "restored": back.get("restored", False), "seconds": time.perf_counter() - t,
        "conv_rect_pool_launches": rp.fused_launches,
        "predictions_equal": bool(np.array_equal(back["test_predictions"],
                                                 res["test_predictions"]))}
    total["conv_rect_pool"] += rp.fused_launches
    log(json.dumps({"phase": "32(a) Cifar --autoCache --pipelineFile on 4x2", "card": card,
                    **rec["cifar"]}))
    r = rec["cifar"]
    if not (r["plan"]["cached"] == ["conv_featurize"] and k1 == want and not rp.launches
            and r["model_equal_phase29"] and r["predictions_equal_phase29"]
            and r["restored"]["restored"] and r["restored"]["predictions_equal"]
            and r["restored"]["conv_rect_pool_launches"]):
        raise AssertionError(f"Cifar --autoCache on 4x2: {r}")
    servable, predictions = res["servable"], res["test_predictions"]
    del res, back

    # (b) VOC --autoCache on 8x1, against phase 30's 8x1 scores.
    torch.cuda.empty_cache()
    fs.launches = 0
    t = time.perf_counter()
    vres = voc.run(voc.SIFTFisherConfig(**VOC_CONF, auto_cache=True), phase6["train"],
                   phase6["test"], mesh=m81)
    total["fv_stats"] += fs.launches
    rec["voc"] = {"plan": slot_charge(vres["cache_plan"], 8), "fv_stats_launches": fs.launches,
                  "scores_equal_phase30": bool(np.array_equal(vres["test_scores"], voc30)),
                  "map": vres["map"], "phase6_map": phase6["map"],
                  "seconds": time.perf_counter() - t}
    log(json.dumps({"phase": "32(b) VOC --autoCache on 8x1", "card": card, **rec["voc"]}))
    if not (rec["voc"]["scores_equal_phase30"] and fs.launches):
        raise AssertionError(f"VOC --autoCache on 8x1: {rec['voc']}")
    del vres

    # (c) (a)'s servable with its scaler mean and block weights placed
    # data@dim0 on 4x2, saved under the mesh, loaded onto 2x1 and 1x1
    # (on 1x1 also host-staged under a 16 KiB chunk, which two of its eight
    # arrays exceed) and applied.
    scaler, model = (copy.copy(n) for n in servable.nodes[-3:-1])
    scaler.mean = autoshard.spec_sharding("data@dim0", m42, 1).place(scaler.mean)
    model.xs = [autoshard.spec_sharding("data@dim0", m42, 2).place(x) for x in model.xs]
    sharded = fitted["cifar_stem"].parent / "cifar_sharded_servable"
    with use_mesh(m42):
        save_pipeline(str(sharded), Pipeline([*servable.nodes[:-3], scaler, model,
                                              servable.nodes[-1]]))
    del servable, scaler, model
    try:
        load_pipeline(str(sharded), device="cuda")
        naive = "loaded"
    except CheckpointMismatch as e:
        naive = str(e)
    rec["reshard"] = {"naive_load": naive, "loads": {}}
    for name, shape, chunk in (("2x1", (2, 1), None), ("1x1", (1, 1), None),
                               ("1x1 host-staged", (1, 1), "16K")):
        mesh = make_mesh(*shape, devices=slots[: shape[0] * shape[1]])
        before = resilience.counters.get("ckpt_reshard")
        rp.fused_launches = 0
        stats: dict = {}
        with env_set(**({"KEYSTONE_RESHARD_CHUNK_BYTES": chunk} if chunk else {})):
            torch.cuda.synchronize()
            t = time.perf_counter()
            restored = load_pipeline(str(sharded), mesh=mesh, report=stats)
            torch.cuda.synchronize()
            load_secs = time.perf_counter() - t
        pred = cifar.apply_servable_chunked(replicate(restored, "cuda"), test.images,
                                            conf.featurize_chunk)
        total["conv_rect_pool"] += rp.fused_launches
        rec["reshard"]["loads"][name] = {
            "ckpt_reshard": resilience.counters.get("ckpt_reshard") - before, **stats,
            "load_seconds": load_secs, "conv_rect_pool_launches": rp.fused_launches,
            "predictions_equal": bool(np.array_equal(pred, predictions))}
        del restored
    log(json.dumps({"phase": "32(c) the reshard loader", "card": card, **rec["reshard"]}))
    loads = rec["reshard"]["loads"]
    if not ("refusing" in naive and "mesh=" in naive
            and all(v["ckpt_reshard"] == 1 and v["predictions_equal"]
                    and v["conv_rect_pool_launches"] for v in loads.values())
            and loads["1x1 host-staged"]["host_staged"] and not loads["1x1"]["host_staged"]):
        raise AssertionError(f"the reshard loader: {rec['reshard']}")

    # (d) Phase 22's tar, --autoTune evaluating every chunk, on 4x2,
    # against the same run without it.
    runs = {}
    empty = LabeledImageBatch(c22["train"].images[:0], c22["train"].labels[:0])
    for tuned in (False, True):
        torch.cuda.empty_cache()
        rp.launches = rp.fused_launches = jd.launches = jd.decode_launches = 0
        with env_set(KEYSTONE_AUTOTUNE_INTERVAL="1"):
            out = cifar.run(dataclasses.replace(c22["conf"], stream_test_tar=str(c22["tar"]),
                                                auto_tune=tuned), c22["train"], empty, mesh=m42)
        total["conv_rect_pool"] += rp.fused_launches
        total["decode_pixels"] += jd.decode_launches
        runs[tuned] = {"launches": {"conv_rect_pool": rp.fused_launches,
                                    "decode_pixels": jd.decode_launches,
                                    "rect_pool": rp.launches, "idct_blocks": jd.launches},
                       "seconds": out["seconds"], "predictions": out["test_predictions"],
                       "autotune": out.get("autotune")}
    at = runs[True]["autotune"]
    rec["tar"] = {"launches": runs[True]["launches"],
                  "untuned_launches": runs[False]["launches"],
                  "retunes": at["retunes"], "final_config": at["final_config"],
                  "seconds": runs[True]["seconds"], "untuned_seconds": runs[False]["seconds"],
                  "predictions_equal": bool(np.array_equal(runs[True]["predictions"],
                                                           runs[False]["predictions"]))}
    log(json.dumps({"phase": "32(d) phase 22's tar --autoTune on 4x2", "card": card,
                    **rec["tar"]}))
    lt = rec["tar"]["launches"]
    if not (rec["tar"]["predictions_equal"] and lt["conv_rect_pool"] and lt["decode_pixels"]
            and not (lt["rect_pool"] or lt["idct_blocks"])):
        raise AssertionError(f"--autoTune on 4x2: {rec['tar']}")
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 32: {rec['seconds']:.2f} s")
    return total


def mesh_bucket_line(engine, slot_budget) -> dict:
    """Per bucket of a mesh engine: parity, data slots, the capture's bytes
    (the whole card's) and the per-slot charge against the slot budget, and
    the launches its graphs recorded and replayed."""
    out = {}
    for b, plan in sorted(engine.memory_plans.items()):
        ex = engine._exec.get(b)
        graphs = ex.graphs() if ex is not None else []
        out[str(b)] = {
            "parity": engine.parity.get(b), "live": ex is not None,
            "data_slots": engine._slot_layout(b)[0], "admitted": plan.admitted,
            "capture_bytes": {k: v for k, v in (plan.reported or {}).items()
                              if k != "slot_charge_bytes"},
            "slot_charge_bytes": (plan.reported or {}).get("slot_charge_bytes"),
            "slot_budget_bytes": slot_budget,
            "recorded": {k: v["launches"] for k, v in engine.graph_kernels().get(b, {}).items()},
            "replays": graphs[0].replays if graphs else 0}
    return out


def check_slot_launches(engine, kernel: str) -> int:
    """Each live bucket's graphs record ``kernel`` once per data slot the
    bucket uses; its launches are then replays x data slots.  Returns the
    launches the replays made."""
    lines = mesh_bucket_line(engine, None)
    made = engine.graph_launches().get(kernel, 0)
    want = sum(r["replays"] * r["data_slots"] for r in lines.values() if r["live"])
    recorded_ok = all(r["recorded"].get(kernel) == r["data_slots"]
                      for r in lines.values() if r["live"])
    if not (recorded_ok and made == want):
        raise AssertionError(f"{engine.label}: {kernel} made {made} launches, expected "
                             f"{want} (replays x data slots): {lines}")
    return made


def run_mesh_serving(card: str, fitted: dict) -> dict:
    """Phase 33: serving on slots of the card.  Each part runs with the
    kernel counts set to 0 just before it and read just after (the
    wrappers' eager launches plus the graphs' replays).  Returns the
    launches by kernel."""
    t_phase = time.perf_counter()
    slots = [torch.device("cuda", 0)] * 8
    m42, m81 = make_mesh(4, 2, devices=slots), make_mesh(8, 1, devices=slots)
    rec: dict = {"phase": "33: serving on slots of the card", "card": card}
    total = {"conv_rect_pool": 0, "fv_stats": 0}
    stem = str(fitted["cifar_stem"])
    images = cifar_loader(str(fitted["cifar_test"])).images
    reqs = np.asarray(images[:SERVE_BENCH_REQUESTS], np.float32)
    want = np.asarray(fitted["cifar_pred"][:SERVE_BENCH_REQUESTS])
    example = np.empty(reqs.shape[1:], np.float32)
    built: list = []

    def build(shape, dtype, mesh):
        eng, cold = kserve.load_engine(stem, example, label="cifar_mesh", mesh=mesh)
        built.append((eng, cold))
        return eng

    # (a) The Cifar servable on 4x2 behind a mesh-anchored router.
    torch.cuda.empty_cache()
    rp.launches = rp.fused_launches = 0
    factory = kfrontend.MeshEngineFactory(build, mesh=m42)
    router = kfrontend.ShapeRouter(factory, label="cifar_mesh",
                                   config=kfrontend.RouterConfig(retire_after_s=600.0))
    try:
        t = time.perf_counter()
        ceng = factory(example.shape, np.float32)
        build_secs = time.perf_counter() - t
        router.add_engine(ceng)
        t = time.perf_counter()
        futs = [router.submit(r) for r in reqs]
        answers = np.stack([f.result(120.0) for f in futs])
        serve_secs = time.perf_counter() - t
        k1 = check_slot_launches(ceng, "conv_rect_pool")
        rec["cifar_4x2"] = {
            "mesh": ceng.record()["mesh"], "router_mesh": router.record()["mesh"],
            "cold_start": built[0][1], "build_seconds": build_secs,
            "buckets": mesh_bucket_line(ceng, kmem.min_chip_budget(m42)[0]),
            "requests": len(reqs), "serve_seconds": serve_secs,
            "answers_equal_phase3": bool(np.array_equal(answers, want)),
            "conv_rect_pool_graph_launches": k1, "conv_rect_pool_eager_launches": rp.fused_launches,
            "rect_pool_launches": rp.launches}
        total["conv_rect_pool"] += k1 + rp.fused_launches
        log(json.dumps({"phase": "33(a) Cifar on 4x2 slots", "card": card, **rec["cifar_4x2"]}))
        r = rec["cifar_4x2"]
        if not (r["answers_equal_phase3"] and r["mesh"] == r["router_mesh"] == "4x2"
                and not rp.launches and ceng.parity_ok):
            raise AssertionError(f"Cifar on 4x2: {r}")

        # (b) Re-anchor onto 2x1, then 1x1, under live traffic.
        rp.launches = rp.fused_launches = 0
        before = resilience.counters.get("mesh_reanchor")
        served: list = []
        errors: list = []
        stop = threading.Event()

        def traffic():
            try:
                i = 0
                while not stop.is_set():
                    batch = [(j % len(reqs), router.submit(reqs[j % len(reqs)]))
                             for j in range(i, i + 16)]
                    served.extend((j, f.result(120.0)) for j, f in batch)
                    i += 16
            except BaseException as e:  # noqa: BLE001 — surfaced below
                errors.append(e)

        th = threading.Thread(target=traffic)
        th.start()
        time.sleep(0.2)
        steps = []
        for shape in ((2, 1), (1, 1)):
            mesh = make_mesh(*shape, devices=slots[: shape[0] * shape[1]])
            n0 = len(served)
            out = router.reanchor(mesh, why="phase 33: the mesh shrinks")
            steps.append({**out, "answered_during": len(served) - n0})
        time.sleep(0.2)
        stop.set()
        th.join(120.0)
        engines = [eng for eng, _ in built]
        k1 = sum(check_slot_launches(eng, "conv_rect_pool") for eng in engines)
        counted = resilience.counters.get("mesh_reanchor") - before
        rec["reanchor"] = {
            "steps": steps, "mesh_reanchor_counted": counted, "answers": len(served),
            "lost": 0 if not errors else len(errors),
            "answers_equal": all(np.array_equal(a, want[j]) for j, a in served),
            "router_mesh": router.record()["mesh"], "errors": [repr(e) for e in errors[:1]],
            "labels": [eng.label for eng in engines]}
        log(json.dumps({"phase": "33(b) re-anchor 4x2 -> 2x1 -> 1x1 under traffic",
                        "card": card, **rec["reanchor"]}))
        r = rec["reanchor"]
        if (errors or counted != 2 or not r["answers_equal"] or r["router_mesh"] != "1x1"
                or any(s["failed"] or not s["reshard_wall_s"] for s in steps)):
            raise AssertionError(f"the re-anchor: {r}")
    finally:
        router.close()
    # The graphs of (a)'s engine replayed in (b) too: (b)'s launches are the
    # replays after (a)'s reading, eager launches beside them.
    total["conv_rect_pool"] += k1 - rec["cifar_4x2"]["conv_rect_pool_graph_launches"]
    total["conv_rect_pool"] += rp.fused_launches
    rec["reanchor"]["conv_rect_pool_launches"] = (
        k1 - rec["cifar_4x2"]["conv_rect_pool_graph_launches"] + rp.fused_launches)
    del built, ceng, factory, router
    torch.cuda.empty_cache()

    # (c) Phase 6's VOC bundle on 8x1 against the single-device engine.
    vconf = voc.SIFTFisherConfig(**VOC_CONF)
    shapes = sorted({img.shape for img in fitted["voc_test"].images},
                    key=lambda sh: -sum(img.shape == sh for img in fitted["voc_test"].images))
    vreq = np.asarray([img for img in fitted["voc_test"].images if img.shape == shapes[0]][:64],
                      np.float32)
    wrap = functools.partial(voc.servable_pipeline, vconf)
    fs.launches = 0
    t = time.perf_counter()
    veng, vcold = kserve.load_engine(str(fitted["voc_stem"]), np.empty(vreq.shape[1:], np.float32),
                                     label="voc_mesh", wrap=wrap, mesh=m81)
    vbuild = time.perf_counter() - t
    got = veng.infer(vreq)
    k2 = check_slot_launches(veng, "fv_stats")
    eager = fs.launches
    total["fv_stats"] += k2 + eager
    one, _ = kserve.load_engine(str(fitted["voc_stem"]), np.empty(vreq.shape[1:], np.float32),
                                label="voc_one", wrap=wrap)
    single = one.infer(vreq)
    equal = bool(np.array_equal(got, single))
    err = float(np.abs(got - single).max())
    rec["voc_8x1"] = {
        "mesh": veng.record()["mesh"], "cold_start": vcold, "build_seconds": vbuild,
        "buckets": mesh_bucket_line(veng, kmem.min_chip_budget(m81)[0]), "requests": len(vreq),
        "request_shape": list(vreq.shape[1:]),
        "vs_single_device": "equal" if equal else "within 1e-5 of max",
        "max_abs_diff": err, "max_abs": float(np.abs(single).max()),
        "fv_stats_graph_launches": k2, "fv_stats_eager_launches": eager}
    log(json.dumps({"phase": "33(c) VOC on 8x1 slots", "card": card, **rec["voc_8x1"]}))
    if not (equal or err <= 1e-5 * float(np.abs(single).max())) or not veng.parity_ok:
        raise AssertionError(f"VOC on 8x1: {rec['voc_8x1']}")
    del veng, one
    torch.cuda.empty_cache()

    # (d) The factory's ladder under a budget that denies every mesh bucket
    # (a slot gets 64K / 8 = 8K, below one 12,288-byte request).
    rp.launches = rp.fused_launches = 0
    ladder: list = []
    servable = load_pipeline(stem)  # restored whole, outside the budget

    def build_small(shape, dtype, mesh):
        eng = kserve.ServingEngine(servable, np.empty(shape, dtype), label="cifar_ladder",
                                   mesh=mesh)
        ladder.append(eng)
        return eng

    before = resilience.counters.get("router_mesh_stepdown")
    with env_set(KEYSTONE_HBM_BUDGET="64K"):
        t = time.perf_counter()
        landed = kfrontend.MeshEngineFactory(build_small, mesh=m42)(example.shape, np.float32)
        ladder_secs = time.perf_counter() - t
    steps_down = resilience.counters.get("router_mesh_stepdown") - before
    ans = landed.infer(reqs[:64])
    rec["ladder"] = {
        "budget": "64K", "tiers_built": [e.record()["mesh"] for e in ladder],
        "landed_mesh": landed.record()["mesh"], "landed_buckets": list(landed.buckets()),
        "router_mesh_stepdown": steps_down, "seconds": ladder_secs,
        "answers_equal_phase3": bool(np.array_equal(ans, want[:64])),
        "conv_rect_pool_launches": rp.fused_launches + sum(
            e.graph_launches().get("conv_rect_pool", 0) for e in ladder)}
    total["conv_rect_pool"] += rec["ladder"]["conv_rect_pool_launches"]
    log(json.dumps({"phase": "33(d) the factory ladder", "card": card, **rec["ladder"]}))
    if not (steps_down == 2 and landed.mesh is None and rec["ladder"]["answers_equal_phase3"]):
        raise AssertionError(f"the factory ladder: {rec['ladder']}")
    del ladder, landed, servable
    torch.cuda.empty_cache()

    # (e) MNIST --serve --serveMesh 1x1 from the CLI against --serve alone.
    absent = str(fitted["cifar_stem"].parent / "absent")
    argv = ["--trainLocation", absent, "--testLocation", str(fitted["mnist"]["test_csv"]),
            *MNIST_FLAGS, "--pipelineFile", str(fitted["mnist"]["stem"]), "--serve"]
    plain = mnist.main(argv)
    meshed = mnist.main([*argv, "--serveMesh", "1x1"])
    ps, ms = plain["serving"], meshed["serving"]
    rec["mnist_cli"] = {
        "mesh": ms["engine"]["mesh"], "cold_start": ms["cold_start"],
        "predictions_equal": bool(np.array_equal(plain["test_predictions"],
                                                 meshed["test_predictions"])),
        "served_bit_identical": [ps["served"]["predictions_bit_identical"],
                                 ms["served"]["predictions_bit_identical"]],
        "router_mesh": ms["served"]["router"]["mesh"]}
    log(json.dumps({"phase": "33(e) MNIST --serve --serveMesh 1x1", "card": card,
                    **rec["mnist_cli"]}))
    if not (rec["mnist_cli"]["predictions_equal"] and all(rec["mnist_cli"]["served_bit_identical"])
            and rec["mnist_cli"]["mesh"] == "1x1"):
        raise AssertionError(f"MNIST --serveMesh: {rec['mnist_cli']}")
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 33: {rec['seconds']:.2f} s")
    return total


def fit_serve_line(j: dict) -> dict:
    """The judged keys of a two-process fit+serve."""
    keys = ("n_images", "bit_identical", "mesh_spans", "crosshost_reshard",
            "crosshost_bit_equal", "leaked_threads", "parity_ok", "join_wall_s", "fit_wall_s",
            "reshard_wall_s", "serve_wall_s", "fit_serve_wall_s", "wall_s", "ref_fit_wall_s",
            "images_per_s_per_rank")
    return {k: j[k] for k in keys}


def check_fit_serve(j: dict, n_images: int) -> None:
    if not (j["bit_identical"] and j["mesh_spans"] and j["crosshost_reshard"] >= 1
            and j["crosshost_bit_equal"] and j["leaked_threads"] == [] and j["parity_ok"]
            and j["n_images"] == n_images):
        raise AssertionError(f"two-process fit+serve: {fit_serve_line(j)}")


def run_multihost(card: str, data_dir: Path) -> dict:
    """Phase 34: multiple processes on the card.  Returns the launches by
    kernel over the phase: this process's, plus what every worker (the
    ranks, the references and the drill's hosts) counted in its own
    process and reported."""
    from keystone_tpu_torch.workloads import multihost

    t_phase = time.perf_counter()
    if not kdist.spawn_available():
        raise AssertionError("phase 34: this host cannot spawn rank processes")
    rp.launches = rp.fused_launches = fs.launches = jd.decode_launches = 0
    rec: dict = {"phase": "34: multiple processes on the card", "card": card}
    # (a) The JAX package's defaults.
    small = multihost.run_two_process_fit_serve(str(data_dir / "mh_small"), device="cuda",
                                                timeout_s=300.0)
    rec["a"] = fit_serve_line(small)
    log(json.dumps({"phase": "34(a) two-process fit+serve, 2x2 shards x 6 images", "card": card,
                    **rec["a"]}))
    check_fit_serve(small, 24)
    # (b) 4,096 images, 2,048 a rank.
    big = multihost.run_two_process_fit_serve(str(data_dir / "mh_big"), shards_per_host=8,
                                              images_per_shard=256, device="cuda",
                                              timeout_s=600.0)
    rec["b"] = fit_serve_line(big)
    log(json.dumps({"phase": "34(b) two-process fit+serve, 2x8 shards x 256 images",
                    "card": card, **rec["b"]}))
    check_fit_serve(big, 4096)
    # (c) The host-loss drill with subprocess hosts.
    drill = multihost.run_host_loss_drill(str(data_dir / "mh_drill"), subprocess_mode=True,
                                          hosts=2, requests=24, device="cuda", timeout_s=240.0)
    survivors = drill["survivor_counters"]
    rec["c"] = {
        "mode": drill["mode"], "requests": drill["requests"], "answered": drill["answered"],
        "dropped_requests": drill["dropped_requests"], "mismatches": drill["mismatches"],
        "errors": drill["errors"], "killed_at_answered": drill["killed_at_answered"],
        "in_flight_at_kill": drill["in_flight_at_kill"],
        "fleet_host_lost": drill["fleet"]["lost_hosts"],
        "dist_reform": min(sc.get("dist_reform", 0) for sc in survivors.values()),
        "host_reanchor": min(sc.get("host_reanchor", 0) for sc in survivors.values()),
        "reanchor_wall_s": drill["reanchor_wall_s"], "wall_s": drill["wall_s"],
        "worker_rcs": drill["worker_rcs"]}
    log(json.dumps({"phase": "34(c) host-loss drill, 2 subprocess hosts", "card": card,
                    **rec["c"]}))
    c = rec["c"]
    if not (c["dropped_requests"] == 0 and c["mismatches"] == 0 and not c["errors"]
            and c["in_flight_at_kill"] >= 1 and c["fleet_host_lost"] >= 1 and c["dist_reform"] >= 1 and c["host_reanchor"] >= 1):
        raise AssertionError(f"host-loss drill: {c}")
    here = {"conv_rect_pool": rp.fused_launches + rp.launches, "fv_stats": fs.launches,
            "decode_pixels": jd.decode_launches}
    by_source = {"this process": here, "(a) workers": small["kernel_launches"],
                 "(b) workers": big["kernel_launches"], "(c) hosts": drill["kernel_launches"]}
    launches = multihost.sum_launches(by_source.values())
    rec["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"phase": "34 launches, each process counting its own", "card": card,
                    **launches, "by_source": by_source}))
    log(f"phase 34: {rec['seconds']:.2f} s")
    return launches


def obs_drill_line(d: dict) -> dict:
    """The judged keys of a fleet-observability drill."""
    inc = d.get("incident", {})
    return {
        "mode": d["mode"], "requests": d["requests"], "answered": d["answered"],
        "dropped_requests": d["dropped_requests"], "mismatches": d["mismatches"],
        "errors": d["errors"], "counter_sum_ok": d["counter_sum_ok"],
        "counter_sum_mismatch": d.get("counter_sum_mismatch"),
        "p99_match": d["p99_match"], "pooled_metric": d.get("pooled_metric"),
        "p99_pool_n": d.get("p99_pool_n"), "p99_fleet": d.get("p99_fleet"),
        "p99_oracle_pick": d.get("p99_oracle_pick"), "p99_oracle_np": d.get("p99_oracle_np"),
        "monotone_ok": d["monotone_ok"], "obs_member_lost": d["obs_member_lost"],
        "fleet_alive": d["fleet_alive"], "fleet_lost": d["fleet_lost"],
        "incident_error": inc.get("error"), "incident_schema": inc.get("schema"),
        "survivor_rings_ok": inc.get("survivor_rings_ok"),
        "events_monotone": inc.get("events_monotone"), "n_events": inc.get("n_events"),
        "capture_wall_s": inc.get("capture_wall_s"), "scrape_wall_s": d["scrape_wall_s"],
        "killed_at_answered": d["killed_at_answered"], "wall_s": d["wall_s"],
        "kernel_launches": d["kernel_launches"], "worker_rcs": d.get("worker_rcs")}


def check_obs_drill(line: dict) -> None:
    if not (line["counter_sum_ok"] and line["p99_match"] and line["monotone_ok"]
            and line["obs_member_lost"] >= 1 and line["dropped_requests"] == 0
            and line["mismatches"] == 0 and line["incident_error"] is None
            and line["incident_schema"] == "keystone.incident/1"
            and line["survivor_rings_ok"] and line["events_monotone"]
            and line["fleet_alive"] == 1 and line["fleet_lost"] == 1):
        raise AssertionError(f"fleet-observability drill: {line}")


def run_fleet_obs(card: str, data_dir: Path) -> dict:
    """Phase 35: fleet observability on the card.  Returns the launches by
    kernel over the phase: this process's, plus what the subprocess
    members counted in their own processes and reported."""
    from keystone_tpu_torch.workloads import multihost

    t_phase = time.perf_counter()
    if not kdist.spawn_available():
        raise AssertionError("phase 35: this host cannot spawn member processes")
    rp.launches = rp.fused_launches = fs.launches = jd.decode_launches = 0
    rec: dict = {"phase": "35: fleet observability", "card": card}
    sub = multihost.run_obs_capture_drill(str(data_dir / "obs_sub"), subprocess_mode=True,
                                          hosts=2, device="cuda", timeout_s=240.0)
    rec["a"] = obs_drill_line(sub)
    log(json.dumps({"phase": "35(a) obs-capture drill, 2 subprocess members", "card": card,
                    **rec["a"]}))
    check_obs_drill(rec["a"])
    inproc = multihost.run_obs_capture_drill(str(data_dir / "obs_in"), subprocess_mode=False,
                                             hosts=2, local_devices=2, device="cuda",
                                             timeout_s=240.0)
    rec["b"] = obs_drill_line(inproc)
    log(json.dumps({"phase": "35(b) obs-capture drill, 2 in-process members on slot pairs",
                    "card": card, **rec["b"]}))
    check_obs_drill(rec["b"])
    here = {"conv_rect_pool": rp.fused_launches + rp.launches, "fv_stats": fs.launches,
            "decode_pixels": jd.decode_launches}
    by_source = {"this process": here, "(a) members": sub["kernel_launches"]}
    launches = multihost.sum_launches(by_source.values())
    rec["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"phase": "35 launches, each process counting its own", "card": card,
                    **launches, "by_source": by_source}))
    log(f"phase 35: {rec['seconds']:.2f} s")
    return launches


_LAUNCH = """
import atexit, json, runpy, sys
from keystone_tpu_torch.ops import rect_pool as rp
atexit.register(lambda: print("LAUNCHES " + json.dumps(
    {"conv_rect_pool": rp.fused_launches, "rect_pool": rp.launches}), flush=True))
sys.argv = ["keystone_tpu_torch", *%r]
runpy.run_module("keystone_tpu_torch", run_name="__main__", alter_sys=True)
"""

#: serve_bench modes of phase 36: name -> (flags, extra environment).
SERVE_BENCH_MODES = {
    "inproc": ([], {}),
    "wire": (["--wire", "--clients", "2"], {}),
    "shift": (["--wire", "--shift"], {}),
    "numerics": (["--numerics"], {}),
    "kill_device": (["--kill-device", "1"],
                    {"KEYSTONE_DIST_DEVICE": "cuda", "KEYSTONE_DIST_LOCAL_SLOTS": "4"}),
    "hosts": (["--hosts", "2", "--kill-host", "1", "--collect"], {}),
    "drift_refit": (["--drift-refit"], {}),
}


def entry_env(data_dir: Path, tag: str, extra: dict | None = None) -> dict:
    """A spawned entry point's environment: this checkout on its import
    path, a plan-outcome log of its own, no inherited trace."""
    env = {k: v for k, v in os.environ.items() if k != "KEYSTONE_TRACE"}
    root = str(Path(__file__).resolve().parent)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    env[autoshard.PLAN_LOG_ENV] = str(data_dir / f"plans_{tag}.jsonl")
    env.update(extra or {})
    return env


def run_process(cmd: list, env: dict, timeout: float) -> tuple:
    """``cmd`` from the checkout's root: (exit code, stdout, stderr, wall)."""
    t = time.perf_counter()
    out = subprocess.run(cmd, cwd=Path(__file__).resolve().parent, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr, time.perf_counter() - t


def logged(stderr: str, pattern: str) -> str:
    """The last capture of ``pattern`` in a workload's log."""
    found = re.findall(pattern, stderr, re.M)
    if not found:
        raise AssertionError(f"no log line matches {pattern!r}: {stderr[-2000:]}")
    return found[-1]


def serve_bench_line(mode: str, rec: dict, wall: float) -> dict:
    """The headline numbers of one serve_bench record."""
    bench = rec.get("bench") or {}
    line = {"mode": mode, "ok": rec.get("ok"), "process_wall_s": round(wall, 3),
            "tool_startup_s": round(wall - rec["seconds"], 3),
            "requests": bench.get("requests"), "qps": bench.get("qps"),
            "per_shape": bench.get("per_shape"), "p50_ms": bench.get("p50_ms"),
            "p99_ms": bench.get("p99_ms")}
    for key in ("wire_p99_ms", "router_route_overhead_us", "reshard_wall_s",
                "reanchor_wall_s", "drift_to_healthy_wall_s", "refit_wall_s", "swap_wall_s",
                "dropped_requests", "reanchor_dropped_requests", "bringup_seconds"):
        if key in rec:
            line[key] = rec[key]
    if "client_processes" in bench:
        line["client_qps"] = [c["pid_record"]["qps"] for c in bench["client_processes"]]
        line["client_startup_s"] = bench["client_startup_s"]
    if "shift" in rec:
        sh = rec["shift"]
        line["shift"] = {k: sh.get(k) for k in ("warm_adds", "retires", "lost_requests")}
        line["shift"]["client_startup_s"] = (sh.get("client") or {}).get("startup_s")
    if "fleet_obs" in rec:
        fo = rec["fleet_obs"]
        line["fleet_obs"] = {k: fo.get(k) for k in ("fleet_p99_ms", "alive", "lost",
                                                     "obs_member_lost", "pooled_metric")}
    return line


def check_serve_bench(mode: str, rc: int, rec: dict) -> None:
    dropped = [rec[k] for k in ("dropped_requests", "reanchor_dropped_requests") if k in rec]
    if rc != 0 or not rec.get("ok") or any(dropped) or rec.get("multihost_unavailable"):
        raise AssertionError(f"serve_bench {mode}: exit {rc}, record {json.dumps(rec)[:2000]}")
    if mode == "shift" and rec["shift"].get("lost_requests") != 0:
        raise AssertionError(f"serve_bench shift lost requests: {rec['shift']}")
    if mode == "hosts" and "fleet_obs" not in rec:
        raise AssertionError("serve_bench --hosts --collect: no fleet_obs section")


def run_entry_points(card: str, data_dir: Path, fitted: dict) -> dict:
    """Phase 36: the launcher and the serving tools, each in a process of
    its own.  Returns the launches by kernel that those processes counted
    (the launcher's Cifar run; the tools' toy engines run no kernel)."""
    t_phase = time.perf_counter()
    rec: dict = {"phase": "36: the port's entry points", "card": card}
    # (a) The launcher: RandomPatchCifar on phase 3's files, then --serveBench.
    flags = [f for f in MAIN_FLAGS if f not in ("--device", "cuda")]
    argv = ["RandomPatchCifar", "--trainLocation", str(fitted["cifar_train"]),
            "--testLocation", str(fitted["cifar_test"]), *flags,
            "--pipelineFile", str(data_dir / "cifar_launcher"), "--serveBench"]
    rc, out, err, wall = run_process([sys.executable, "-c", _LAUNCH % (argv,)],
                                     entry_env(data_dir, "launcher"), 600)
    if rc != 0:
        raise AssertionError(f"python -m keystone_tpu_torch RandomPatchCifar: exit {rc}: "
                             f"{err[-3000:]}")
    launched = json.loads(logged(out, r"^LAUNCHES (.*)$"))
    train_err = 100.0 * float(logged(err, r"Training error is: (\S+)$"))
    test_err = 100.0 * float(logged(err, r"Test error is: (\S+)$"))
    bench = re.search(r"SLO bench — (\d+) requests via (\d+) clients: p50 (\S+)ms, "
                      r"p99 (\S+)ms, (\S+) QPS .*bit_identical=(\w+)", err)
    need = math.ceil(N_TRAIN / 2048) + math.ceil(N_TEST / 2048)
    rec["a"] = {"argv": argv[:1] + ["..."] + argv[-3:], "wall_s": round(wall, 3),
                "train_error": train_err, "test_error": test_err,
                "phase3_train_error": fitted["cifar_train_error"],
                "phase3_test_error": fitted["cifar_test_error"],
                "conv_rect_pool_launches": launched["conv_rect_pool"],
                "rect_pool_launches": launched["rect_pool"],
                "serve_bench": None if bench is None else {
                    "requests": int(bench[1]), "clients": int(bench[2]),
                    "p50_ms": float(bench[3]), "p99_ms": float(bench[4]),
                    "qps": float(bench[5]), "bit_identical": bench[6] == "True"}}
    log(json.dumps({"phase": "36(a) python -m keystone_tpu_torch RandomPatchCifar "
                    "--serveBench", "card": card, **rec["a"]}))
    a = rec["a"]
    if not (a["conv_rect_pool_launches"] >= need and a["rect_pool_launches"] == 0
            and train_err == fitted["cifar_train_error"]
            and test_err == fitted["cifar_test_error"]
            and a["serve_bench"] is not None and a["serve_bench"]["bit_identical"]):
        raise AssertionError(f"launcher run: {a} (K1 needs >= {need} launches)")
    # (b) serve_bench, mode by mode.
    rec["b"] = {}
    for mode, (mode_flags, extra) in SERVE_BENCH_MODES.items():
        rc, out, err, wall = run_process(
            [sys.executable, "-m", "keystone_tpu_torch.tools.serve_bench", *mode_flags,
             "--timeout", "120"],
            entry_env(data_dir, f"serve_bench_{mode}", extra), 400)
        lines = out.splitlines()
        if not lines:
            raise AssertionError(f"serve_bench {mode}: exit {rc}, no record: {err[-3000:]}")
        bench_rec = json.loads(lines[0])
        rec["b"][mode] = serve_bench_line(mode, bench_rec, wall)
        log(json.dumps({"phase": f"36(b) serve_bench {mode}", "card": card,
                        **rec["b"][mode]}))
        check_serve_bench(mode, rc, bench_rec)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 36: {rec['seconds']:.2f} s")
    return {"conv_rect_pool": launched["conv_rect_pool"] + launched["rect_pool"],
            "fv_stats": 0, "decode_pixels": 0}


_CHAOS_RUN = """
import atexit, json, runpy, sys
from keystone_tpu_torch.ops import fv_stats as fs, jpeg_device as jd, rect_pool as rp
atexit.register(lambda: print("LAUNCHES " + json.dumps({
    "conv_rect_pool": rp.fused_launches + rp.launches, "fv_stats": fs.launches,
    "decode_pixels": jd.decode_launches, "entropy_backend": jd.entropy_backend()}), flush=True))
sys.argv = ["chaos_run", *%r]
runpy.run_module("keystone_tpu_torch.tools.chaos_run", run_name="__main__", alter_sys=True)
"""


def run_chaos(card: str, data_dir: Path) -> dict:
    """Phase 37: the chaos suite on the card.  Returns the launches by
    kernel over the phase: the tool's process's counts (read at its exit)
    plus this process's."""
    from keystone_tpu_torch.testing import chaos

    t_phase = time.perf_counter()
    rec: dict = {"phase": "37: the chaos suite on the card", "card": card}
    # (a) The tool over every family, a process of its own.
    trace_dir = data_dir / "chaos_traces"
    rc, out, err, wall = run_process(
        [sys.executable, "-c", _CHAOS_RUN % (["--device", "cuda", "--trace", str(trace_dir)],)],
        entry_env(data_dir, "chaos"), 600)
    lines = out.splitlines()
    if not lines or not lines[0].startswith("{"):
        raise AssertionError(f"chaos_run: exit {rc}, no record: {err[-3000:]}")
    tool = json.loads(lines[0])
    launched = json.loads(logged(out, r"^LAUNCHES (.*)$"))
    backend = launched.pop("entropy_backend")
    families = {r["fault"]["kind"]: {"seed": r["seed"], "outcome": r["outcome"],
                                     "error_type": r["error_type"], "phase": r["phase"],
                                     "seconds": r["seconds"]} for r in tool["results"]}
    rec["a"] = {"exit": rc, "ok": tool["ok"], "outcomes": tool["outcomes"],
                "trace_violations": tool["trace"]["violations"], "process_wall_s": round(wall, 3),
                "schedules_s": round(sum(r["seconds"] for r in tool["results"]), 3),
                "entropy_backend": backend, "launches": launched, "families": families}
    log(json.dumps({"phase": "37(a) python -m keystone_tpu_torch.tools.chaos_run --device "
                    "cuda --trace DIR, tier-1 seeds on MnistRandomFFT", "card": card,
                    **rec["a"]}))
    # Every schedule ends as a healthy system's would, its family's fault
    # counted: a family whose injection point the card's path bypasses
    # would end completed_equal with no fault at all.
    bad = [r for r in tool["results"]
           if r["outcome"] != chaos.expected_outcome(chaos.make_schedule(r["seed"]))
           or r["counters_delta"].get(chaos.EXPECTED_COUNTER[r["fault"]["kind"]], 0) < 1]
    if (rc != 0 or not tool["ok"] or bad or tool["trace"]["violations"]
            or tool["seeds"] != list(chaos.TIER1_SEEDS)
            or set(families) != set(chaos.FAMILIES)):
        raise AssertionError(f"chaos_run on the card: exit {rc}, bad {bad}, trace "
                             f"{tool['trace']['violations']}: {err[-2000:]}")
    # (b) RandomPatchCifar's out-of-memory step-down and NaN guard, here.
    rp.launches = rp.fused_launches = fs.launches = jd.decode_launches = 0
    t_b = time.perf_counter()
    want = {0: "completed_equal", 4: "typed_error"}
    cifar_runs = {}
    for seed, outcome in want.items():
        r = chaos.run_schedule(seed, "cifar", device="cuda")
        cifar_runs[seed] = {k: r.record()[k] for k in ("outcome", "error_type", "seconds",
                                                       "counters_delta")}
        if (r.outcome != outcome
                or r.counters_delta.get(chaos.EXPECTED_COUNTER[r.fault.kind], 0) < 1):
            raise AssertionError(f"chaos cifar seed {seed}: {r.record()}")
    here = {"conv_rect_pool": rp.fused_launches + rp.launches, "fv_stats": fs.launches,
            "decode_pixels": jd.decode_launches}
    rec["b"] = {"runs": cifar_runs, "wall_s": round(time.perf_counter() - t_b, 3),
                "launches": here}
    log(json.dumps({"phase": "37(b) run_schedule on cuda, RandomPatchCifar seeds 0 and 4",
                    "card": card, **rec["b"]}))
    if here["conv_rect_pool"] < 1 or rp.launches:
        raise AssertionError(f"chaos cifar: K1 launches {here}, rect_pool entry {rp.launches}")
    # (c) K3 in the tool's device-decode families.
    if launched["decode_pixels"] < 1:
        raise AssertionError(f"chaos_run's device-decode families launched no decode: "
                             f"{launched}")
    launches = {k: here[k] + launched[k] for k in here}
    rec["seconds"] = time.perf_counter() - t_phase
    log(json.dumps({"phase": "37 launches, each process counting its own", "card": card,
                    **launches, "by_source": {"this process": here, "chaos_run": launched}}))
    log(f"phase 37: {rec['seconds']:.2f} s")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is available", file=sys.stderr)
        return 1
    # The synthetic data lives under the checkout's git-ignored build/.
    _build.BUILD_DIR.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR.parent) as tmp:
        return smoke(Path(tmp))


def smoke(data_dir: Path) -> int:
    """Every phase, the CIFAR files of phases 3 and 14 under ``data_dir``."""
    t_script = time.perf_counter()

    def elapsed(after: str) -> None:
        """The script's wall so far, so a later phase can see which earlier
        one to cut against the time limit."""
        log(f"elapsed after {after}: {time.perf_counter() - t_script:.1f} s")

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    resolve_device("cuda")  # full f32, no TF32, for every plain version timed below
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    # Every fit searches its placement and logs the outcome: this run's
    # seeded fits must neither train nor be trained by the host's log.
    log(f"plan-outcome log: {autoshard.hermetic_plan_log()}")

    # 1. Build every kernel from the checkout's sources.
    t = time.perf_counter()
    libs = _build.build("rect_pool", "fv_stats", "idct", "entropy")
    log(f"built {sorted(libs)} in {time.perf_counter() - t:.2f} s")

    # 2. Kernel against its plain version on the card.
    gen = torch.Generator(device="cuda").manual_seed(0)
    prod = check_rect_pool(PROD, torch.bfloat16, gen, timed=True)
    prod_f32 = check_rect_pool(PROD, torch.float32, gen, timed=True)
    odd = [check_rect_pool(s, dt, gen, timed=False)
           for s in ODD for dt in (torch.float32, torch.bfloat16)]
    log("rect_pool library_ms: null (no single PyTorch call rectifies and "
        "sum-pools both signs)")
    fused_prod = check_conv_rect_pool(PROD, torch.bfloat16, (True, True), gen, timed=True)
    fused_prod_f32 = check_conv_rect_pool(PROD, torch.float32, (True, True), gen, timed=True)
    fused_odd = [check_conv_rect_pool(s, dt, fl, gen, timed=False)
                 for s in ODD for dt in (torch.float32, torch.bfloat16) for fl in FUSED_FLAGS]
    fused_odd += [check_conv_rect_pool((64, *PROD[1:]), torch.bfloat16, fl, gen, timed=False)
                  for fl in FUSED_FLAGS[1:]]
    fused_served = {n: time_conv_rect_pool(n, gen) for n in K1_SERVED}
    fused_cifar48 = check_conv_rect_pool(CIFAR48, torch.bfloat16, (True, True), gen,
                                         timed=True)
    log("conv_rect_pool library_ms: null (no single PyTorch call applies the "
        "Convolver's epilogue, rectifies and sum-pools both signs)")
    fv_prod = check_fv_stats(FV_PROD, gen, timed=True)
    fv_odd = [check_fv_stats(s, gen, timed=False) for s in FV_ODD]
    torch.cuda.empty_cache()
    fv_served = {n: time_fv_stats(n, gen) for n in FV_SERVED}
    torch.cuda.empty_cache()
    fv_imagenet = {}
    for branch, (cols, ragged) in FV_IMAGENET.items():
        fv_imagenet[branch] = check_fv_stats((8, 64, cols, 16, ragged), gen, timed=False)
        fv_imagenet[branch]["by_batch"] = {
            n: time_fv_stats(n, gen, 64, cols, 16, plain=True) for n in FV_IMAGENET_BATCHES}
        torch.cuda.empty_cache()
    log("fv_stats library_ms: null (no single PyTorch call computes GMM "
        "posteriors and their weighted moments)")
    idct_prod = check_idct(IDCT_PROD, gen, timed=True)
    idct_odd = [check_idct(s, gen, timed=False) for s in IDCT_ODD]
    decode_checks = [check_decode(case, gen) for case in DECODE_CASES]
    decode_cifar48 = time_decode(*random_coeff_batch(DECODE_CASES[1], gen))
    elapsed("phase 2")
    torch.cuda.empty_cache()
    log("decode_pixels library_ms: null (no single PyTorch call decodes JPEG "
        "coefficients to pixels; the IDCT entry's yardstick is torch.einsum)")

    train_path, test_path = data_dir / "train.bin", data_dir / "test.bin"
    rng = np.random.default_rng(5)
    palette = rng.uniform(40, 215, (N_CLASSES, 3))
    write_cifar(train_path, N_TRAIN, rng, palette)
    write_cifar(test_path, N_TEST, rng, palette)
    test = cifar_loader(str(test_path))
    test_images = test.images

    # 3. + 4. The main path: fit, eval, then the servable apply.
    rp.launches = rp.fused_launches = 0
    torch.cuda.reset_peak_memory_stats()
    res = cifar.main(["--trainLocation", str(train_path), "--testLocation", str(test_path),
                      *MAIN_FLAGS, "--pipelineFile", str(data_dir / "cifar_servable")])
    fit_launches = rp.fused_launches
    fitted = {"cifar_train": train_path, "cifar_test": test_path,
              "cifar_stem": data_dir / "cifar_servable",
              "cifar_pred": res["test_predictions"], "cifar_seconds": res["seconds"],
              "cifar_fit_launches": fit_launches,
              "cifar_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "cifar_train_error": res["train_error"], "cifar_test_error": res["test_error"],
              "cifar_featurize_seconds": res["featurize_seconds"]}
    servable = res["servable"]
    for chunk in (1, 4, 16, 64):
        served = cifar.apply_servable_chunked(servable, test_images[:256], chunk)
        if not np.array_equal(served, res["test_predictions"][:256]):
            raise AssertionError(f"servable apply at batch {chunk} != offline predictions")
    main_launches, unfused_launches = rp.fused_launches, rp.launches
    need = math.ceil(N_TRAIN / 2048) + math.ceil(N_TEST / 2048)
    if fit_launches < need or unfused_launches:
        raise AssertionError(f"conv_rect_pool launched {fit_launches} times, expected >= "
                             f"{need}; rect_pool {unfused_launches} times, expected 0")
    if not res["test_error"] < 45.0:  # chance is 90%
        raise AssertionError(f"test error {res['test_error']}% is not well under chance")
    log(json.dumps({
        "main_path": "RandomPatchCifar", "card": card,
        "train_images": N_TRAIN, "test_images": N_TEST,
        "train_error": res["train_error"], "test_error": res["test_error"],
        "featurize_images_per_sec": res["featurize_images_per_sec"],
        "featurize_seconds": res["featurize_seconds"],
        "learn_seconds": res["learn_seconds"],
        "solve_seconds": res["solve_seconds"], "seconds": res["seconds"],
        "conv_rect_pool_launches_fit": fit_launches,
        "conv_rect_pool_launches_serve": main_launches - fit_launches,
        "peak_memory_gb": fitted["cifar_peak_gb"],
        "rect_pool_launches": unfused_launches,
    }))
    log("featurize breakdown " + json.dumps(
        {"card": card, **featurize_breakdown(servable.nodes[0], test_images[:2048])}
    ))

    # 5. Card against CPU inside the port, on one fitted state.
    arrays = convert.to_arrays(servable)
    x = torch.from_numpy(test_images[:256])
    for dtype, bound in ((torch.bfloat16, 1e-2), (torch.float32, 2e-5)):
        state = {**arrays, "activation_dtype": dtype}
        on_card = convert.from_arrays(**state, device="cuda").featurizer(x).cpu()
        on_cpu = convert.from_arrays(**state, device="cpu").featurizer(x)
        err = rel_err(on_card, on_cpu)
        log(f"features card vs cpu ({dtype}): max rel err {err:.3e} (bound {bound})")
        if dtype == torch.float32:
            torch.testing.assert_close(on_card, on_cpu, rtol=bound,
                                       atol=bound * on_cpu.abs().max().item())
        elif not err <= bound:
            raise AssertionError(f"bf16 features differ by {err} > {bound}")
    labels = ClassLabelIndicatorsFromIntLabels(N_CLASSES)(torch.from_numpy(test.labels[:256]))
    models = {}
    for dev in ("cuda", "cpu"):
        feats = on_cpu.to(dev)
        scaled = StandardScaler().fit(feats)(feats)
        model = BlockLeastSquaresEstimator(4096, 1, 10.0).fit(scaled, labels.to(dev))
        models[dev] = (model.xs[0].cpu(), model(scaled).cpu())
    w_err = rel_err(models["cuda"][0], models["cpu"][0])
    s_err = rel_err(models["cuda"][1], models["cpu"][1])
    log(f"solve card vs cpu: weights max rel err {w_err:.3e}, scores {s_err:.3e} (bound 1e-3)")
    if not (w_err <= 1e-3 and s_err <= 1e-3):
        raise AssertionError("the solve differs between card and CPU beyond 1e-3")

    voc_launches, voc_train, voc_test, voc_map, voc_secs, voc_scores, voc_report = run_voc(
        card, data_dir / "voc_bundle")
    decode_launches, tar_fv_launches, decode_times, tar_map, tar_secs = run_voc_tar(
        card, voc_train, voc_test, voc_map, data_dir / "voc_tars")
    fitted.update(voc_stem=data_dir / "voc_bundle", voc_test=voc_test, voc_map=voc_map,
                  voc_seconds=voc_secs, voc_tars=data_dir / "voc_tars", voc_tar_map=tar_map,
                  voc_tar_seconds=tar_secs)
    # Phase 26 refits phase 6 on the same images.
    phase6 = {"train": voc_train, "test": voc_test, "map": voc_map, "scores": voc_scores,
              "fit_report": voc_report}
    del voc_train
    elapsed("phases 3-8")
    fitted["mnist"] = run_mnist(card, data_dir / "mnist")
    elapsed("phases 9-11")
    timit12 = run_timit(card)
    elapsed("phases 12-13")
    random_cifar_rec = run_cifar_variants(card, train_path, test_path)
    run_newsgroups(card, data_dir / "newsgroups")
    elapsed("phases 14-15")
    torch.cuda.empty_cache()
    inet_launches, inet_train, inet_test, inet_fitted = run_imagenet(
        card, data_dir / "imagenet_bundle")
    inet_tar_decode, inet_tar_fv = run_imagenet_tar(card, inet_train, inet_test)
    inet_restored = run_imagenet_restored(card, inet_test, inet_fitted)
    elapsed("phases 17-19 and 27(d)")
    # Phase 30 reruns phase 17 on the mesh.
    inet17 = {"train": inet_train, "test": inet_test, **inet_fitted}
    del inet_train, inet_test, inet_fitted
    run_descriptors(card)
    run_text(card)
    elapsed("phases 20-21")
    tar_launches, cifar_tar = run_cifar_tar(card, train_path, test_path, data_dir)
    elapsed("phase 22")
    restored = run_restored(card, data_dir, fitted)
    elapsed("phase 23")
    snaps, snap24 = run_snapshots(card, data_dir, cifar_tar, fitted)
    elapsed("phase 24")
    serving = run_serving(card, data_dir, fitted)
    elapsed("phase 25")
    ladder = run_ladder(card, data_dir, phase6, timit12)
    elapsed("phase 26")
    optimizer = run_optimizer(card, fitted, cifar_tar, phase6)
    elapsed("phase 27")
    t28 = time.perf_counter()
    placement = run_placement(card, fitted, phase6, timit12)
    lifecycle = run_lifecycle(card, data_dir, cifar_tar, snap24)
    log(f"phase 28: {time.perf_counter() - t28:.2f} s")
    del snap24
    mesh = run_mesh(card, fitted, timit12)
    del timit12
    mesh_fv = run_mesh_fv(card, data_dir, fitted, phase6, inet17, ladder["bwls_fused"])
    del inet17
    mesh_specs = run_mesh_specs(card, fitted)
    mesh_cache = run_mesh_cache_ckpt(card, fitted, phase6, cifar_tar, mesh["cifar_4x2"],
                                     mesh_fv["voc_8x1_scores"])
    del phase6, cifar_tar
    mesh_serving = run_mesh_serving(card, fitted)
    multihost34 = run_multihost(card, data_dir)
    elapsed("phase 34")
    fleet_obs35 = run_fleet_obs(card, data_dir)
    elapsed("phase 35")
    entry36 = run_entry_points(card, data_dir, fitted)
    elapsed("phase 36")
    chaos37 = run_chaos(card, data_dir)
    elapsed("phase 37")

    # 16. The kernels line, the card line, the result line.
    print(json.dumps({"kernels": [{
        "name": "conv_rect_pool",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/rect_pool.cu",
        "replaces": "keystone_tpu/ops/rect_pool_pallas.py:78",
        "launches": (main_launches + random_cifar_rec["launches"]
                     + tar_launches["conv_rect_pool"] + restored["conv_rect_pool"]
                     + snaps["conv_rect_pool"] + serving["conv_rect_pool"]
                     + optimizer["conv_rect_pool"] + placement["conv_rect_pool"]
                     + lifecycle["conv_rect_pool"] + mesh["conv_rect_pool"]
                     + mesh_specs["conv_rect_pool"] + mesh_cache["conv_rect_pool"]
                     + mesh_serving["conv_rect_pool"] + multihost34["conv_rect_pool"]
                     + fleet_obs35["conv_rect_pool"] + entry36["conv_rect_pool"]
                     + chaos37["conv_rect_pool"]),
        "launches_by_path": {"random_patch_cifar": main_launches,
                             "random_cifar": random_cifar_rec["launches"],
                             "random_patch_cifar_jpeg_tar": tar_launches["conv_rect_pool"],
                             "random_patch_cifar_restored": restored["conv_rect_pool"],
                             "snapshots_and_backends": snaps["conv_rect_pool"],
                             "serving_graphs_and_eager": serving["conv_rect_pool"],
                             "auto_cache_and_auto_tune": optimizer["conv_rect_pool"],
                             "placement_search": placement["conv_rect_pool"],
                             "lifecycle_refit_and_swap": lifecycle["conv_rect_pool"],
                             "mesh_slots": mesh["conv_rect_pool"],
                             "mesh_spec_layouts": mesh_specs["conv_rect_pool"],
                             "mesh_auto_cache_and_reshard": mesh_cache["conv_rect_pool"],
                             "mesh_serving": mesh_serving["conv_rect_pool"],
                             "multihost": multihost34["conv_rect_pool"],
                             "fleet_obs": fleet_obs35["conv_rect_pool"],
                             "entry_points": entry36["conv_rect_pool"],
                             "chaos": chaos37["conv_rect_pool"]},
        "max_abs_err": max(r["max_abs_err"] for r in [
            fused_prod, fused_prod_f32, fused_cifar48, *fused_odd, random_cifar_rec]),
        "ms": fused_prod["ms"],
        "plain_ms": fused_prod["plain_ms"],
        "bound_ms": fused_prod["bound_ms"],
        "bound_by": fused_prod["bound_by"],
        "library_ms": None,
        "f32": {k: fused_prod_f32[k] for k in ("ms", "plain_ms", "bound_ms")},
        "random_cifar_f32": {k: random_cifar_rec[k]
                             for k in ("ms", "plain_ms", "bound_ms", "bound_share")},
        "cifar48": {"shape": list(CIFAR48[:4]),
                    **{k: fused_cifar48[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                     "bound_share")}},
        "ms_by_batch": {**{str(n): r["ms"] for n, r in fused_served.items()},
                        str(PROD[0]): fused_prod["ms"]},
        "bound_share": {**{str(n): r["bound_share"] for n, r in fused_served.items()},
                        str(PROD[0]): fused_prod["bound_share"]},
        "rect_pool_entry": {
            "max_abs_err": max(r["max_abs_err"] for r in [prod, prod_f32, *odd]),
            "launches": unfused_launches,
            **{k: prod[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "f32": {k: prod_f32[k] for k in ("ms", "plain_ms", "bound_ms")},
        },
    }, {
        "name": "fv_stats",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fv_stats.cu",
        "replaces": "keystone_tpu/ops/fv_pallas.py:95",
        "launches": (voc_launches + tar_fv_launches + inet_launches + inet_tar_fv
                     + restored["fv_stats_in_memory"] + restored["fv_stats_jpeg_tars"]
                     + snaps["fv_stats"] + serving["fv_stats"] + ladder["fv_stats"]
                     + optimizer["fv_stats"] + inet_restored + placement["fv_stats"]
                     + mesh_fv["fv_stats"] + mesh_cache["fv_stats"] + mesh_serving["fv_stats"]
                     + multihost34["fv_stats"] + fleet_obs35["fv_stats"] + chaos37["fv_stats"]),
        "launches_by_path": {"voc_in_memory": voc_launches, "voc_jpeg_tars": tar_fv_launches,
                             "imagenet_in_memory": inet_launches,
                             "imagenet_jpeg_tars": inet_tar_fv,
                             "voc_restored_in_memory": restored["fv_stats_in_memory"],
                             "voc_restored_jpeg_tars": restored["fv_stats_jpeg_tars"],
                             "snapshots_and_backends": snaps["fv_stats"],
                             "serving_graphs_and_eager": serving["fv_stats"],
                             "voc_solver_ladder": ladder["fv_stats"],
                             "voc_auto_cache": optimizer["fv_stats"],
                             "imagenet_restored": inet_restored,
                             "voc_placement_search": placement["fv_stats"],
                             "mesh_slots": mesh_fv["fv_stats"],
                             "voc_mesh_auto_cache": mesh_cache["fv_stats"],
                             "mesh_serving": mesh_serving["fv_stats"],
                             "multihost": multihost34["fv_stats"],
                             "fleet_obs": fleet_obs35["fv_stats"],
                             "chaos": chaos37["fv_stats"]},
        "max_abs_err": max(r["max_abs_err"] for r in [fv_prod, *fv_odd, *fv_imagenet.values()]),
        "ms": fv_prod["ms"],
        "plain_ms": fv_prod["plain_ms"],
        "bound_ms": fv_prod["bound_ms"],
        "bound_by": fv_prod["bound_by"],
        "library_ms": None,
        "ms_by_batch": {**{str(n): r["ms"] for n, r in fv_served.items()},
                        str(FV_PROD[0]): fv_prod["ms"]},
        "bound_share": {**{str(n): r["bound_share"] for n, r in fv_served.items()},
                        str(FV_PROD[0]): fv_prod["bound_share"]},
        "mesh_slot": {name: {k: r[k] for k in ("shape", "ms", "bound_ms", "bound_share")}
                      | ({"plain_ms": r["plain_ms"]} if "plain_ms" in r else {})
                      for name, r in mesh_fv["fv_stats_slot"].items()},
        "imagenet": {branch: {
            "shape": [64, FV_IMAGENET[branch][0]], "k": 16, "max_abs_err": r["max_abs_err"],
            "bound_by": r["by_batch"][1]["bound_by"],
            **{key: {str(n): t[key] for n, t in r["by_batch"].items()}
               for key in ("ms", "plain_ms", "bound_ms", "bound_share")},
        } for branch, r in fv_imagenet.items()},
    }, {
        "name": "decode_pixels",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/idct.cu",
        "replaces": "keystone_tpu/ops/jpeg_device.py:743",
        "launches": (decode_launches + inet_tar_decode + tar_launches["decode_pixels"]
                     + restored["decode_pixels"] + snaps["decode_pixels"]
                     + optimizer["decode_pixels"] + mesh_cache["decode_pixels"]
                     + multihost34["decode_pixels"] + fleet_obs35["decode_pixels"]
                     + chaos37["decode_pixels"]),
        "launches_by_path": {"voc_jpeg_tars": decode_launches,
                             "imagenet_jpeg_tars": inet_tar_decode,
                             "cifar_jpeg_tar": tar_launches["decode_pixels"],
                             "voc_restored_jpeg_tars": restored["decode_pixels"],
                             "snapshots_and_backends": snaps["decode_pixels"],
                             "cifar_jpeg_tar_auto_tune": optimizer["decode_pixels"],
                             "cifar_jpeg_tar_mesh_auto_tune": mesh_cache["decode_pixels"],
                             "multihost": multihost34["decode_pixels"],
                             "fleet_obs": fleet_obs35["decode_pixels"],
                             "chaos": chaos37["decode_pixels"]},
        "max_abs_err": max(r["max_abs_err"] for r in decode_checks),
        "ms": decode_times[64]["ms"],
        "plain_ms": decode_times[64]["plain_ms"],
        "bound_ms": decode_times[64]["bound_ms"],
        "bound_by": decode_times[64]["bound_by"],
        "library_ms": None,
        "ms_by_batch": {str(b): r["ms"] for b, r in decode_times.items()},
        "plain_ms_by_batch": {str(b): r["plain_ms"] for b, r in decode_times.items()},
        "bound_share": {str(b): r["bound_share"] for b, r in decode_times.items()},
        "cifar48": {"batch": decode_cifar48["batch"], "size": [CIFAR_TAR_PX, CIFAR_TAR_PX],
                    **{k: decode_cifar48[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "bound_share")}},
        "idct_entry": {
            "max_abs_err": max(r["max_abs_err"] for r in [idct_prod, *idct_odd]),
            **{k: idct_prod[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")},
        },
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
