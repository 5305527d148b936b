#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``keystone_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile every kernel from the checkout's CUDA sources, and the
   native host shim from its C++ source, into ``build/keystone_tpu_torch``.
3. Kernel against plain: each kernel's wrapper on card tensors at the
   shapes the main path gives it (and ragged ones, and the geometries
   the featurize and FV kernels take past the main path's), held against
   its plain PyTorch version on the same inputs; the 3xTF32 kernels
   also against float64: featurize no worse than 2x the plain float32
   version, Gram within its own bar at every shape (and no worse than 2x
   the plain version at the streamed fit's chunk shape). Then each
   kernel and its plain version on an input with one NaN: the same
   non-finite outputs; the banded kernels, which sum over each tile's
   live range as the TPU kernel does, those of that range's reach,
   inside the plain version's (the ``[nan]`` lines).
4. Main path: RandomPatchCifar fit + apply at the full width of the
   repository's bench configuration (1024 filters, 8192 features, two
   4096-wide BCD blocks) on surrogate CIFAR (20480 train / 4096 test
   images), through ``Pipeline.fit`` / ``apply`` / ``apply_datum``;
   then LinearPixels on the same data. Accuracy must land in the
   surrogate's bands and the featurize kernel must have launched. The
   fitted model is saved with ``save_pipeline`` for phase 4c.
4b. Streamed path: the same fit out of core, the training images
   streamed from the host in chunks of 1024 with prefetch depth 2
   (``StreamingDataset``), the scaler and the BCD solver accumulating
   chunk by chunk through the Gram kernel, under an explicit device
   budget; applied chunk by chunk to a test stream and to resident
   data. Launch counts, accuracy, agreement with phase 4 and the
   stream's residency are asserted; both fits' device-memory peaks are
   printed. Both fits' solves are redone in float64 on their own inputs,
   in the data form and (streamed) the Gram form, and each fit's weights
   are held against the float64 ones and against each other; the Gram
   kernel is held against float64 on the first training chunk as the
   solver pass feeds it.
4c. Serving: the saved model admitted three times into a
   ``ServingPlane`` (f32, bf16 and int8 weights) under a device budget
   that holds three charges and not four, served through
   ``plane.submit`` (the 4096 test images from 8 client threads, request
   sizes 1-64), over HTTP (32 small requests per model) and by a
   ``python -m keystone_tpu_torch serve`` subprocess. Launch counts,
   agreement with phase 4, the quantized parity bars, test errors, a
   refused fourth admission, bit-identical eviction + readmission and
   the HTTP statuses are asserted; rows/s, request latency, batch fill,
   warmup, charges and device-memory peaks are printed. The plane serves
   every bucket from a CUDA graph captured at admission, so the traffic's
   launches are each graph's recorded launches times its replays
   (``graphs.REPLAYED_LAUNCHES``) plus the wrappers' eager ones (a
   wrapper called under capture counts in ``kernels.CAPTURED``).
4m. The serving fleet: three ``python -m keystone_tpu_torch.serving.
   replica --device cuda`` processes on the one card (each its own CUDA
   context, measured), behind a ``FleetRouter`` served over HTTP; a
   ``FleetController`` registers phase 4c's saved model at f32, bf16 and
   int8 (f32 hot, so it is replicated), places and sha-verifies every
   copy. Printed and asserted: the captures per replica and model, their
   seconds, the graph pools' bytes within the pools the admission charge
   probed and no more than POOL_CHARGE_MARGIN over them; graph
   replay ``torch.equal`` to the eager apply of the same padded bucket
   for each weight type (in process, on the score pipelines); a seeded
   ``generate_trace`` (Poisson, Zipf over the three models, 1-64 rows)
   replayed through ``HttpServingClient`` to the router by 8 closed-loop
   clients for FLEET_WINDOW_S seconds, with rows/s, ``request_ms`` p50
   and p99, availability, ``router.spill_total``, and a
   ``compile.unexpected_total`` delta of 0 on every replica; mid-trace
   the busiest replica gets SIGKILL: the reactor's tick classifies the
   death (``fleet.replica_deaths_total`` 1), the lost models are
   re-admitted on the survivors with their sha verified, and no outcome
   is unclassified. The window's launches are the replicas' graph
   replays (served traffic), and apart from them the eager launches of
   the re-admission's probes and warm applies. Then the test set through
   the router holds phase
   4c's bars. Device ms of a bucket from the graph against the eager
   apply, and host microseconds a request on each path, at n = 1, 8,
   64. Then the six single-plane chaos scenarios on a CUDA plane at the
   catalogue's seed and the JAX floors.
4d. VOCSIFTFisher: fit + apply at the reference's published defaults
   (80-dim PCA, 256-component GMM, 40,960 Fisher-vector features, 10
   BCD blocks of 4096 over 20 classes, 10^6 PCA and GMM samples, SIFT
   step 4, bin 6, 5 scales) on surrogate VOC images at 375 x 500 and
   500 x 375 (512 train, 256 test), through ``build_pipeline`` /
   ``fit`` / ``apply`` and the mean average precision. Every SIFT
   application must launch ``banded_matmul`` 10 times (one two-sided
   launch per band contraction, two a scale) and every Fisher vector
   ``fv_moments`` once; the GMM must be a distribution with positive
   variances; the MAP must beat a seeded random score matrix and stay
   within 0.01 of the first sound reading; 8 test images go through SIFT
   -> PCA -> FV with the kernels and with the plain versions, both on
   the card, within the golden envelope, and each path's Fisher vectors
   are held against float64.
   Fit and apply seconds, images/s, EM iterations and the device-memory
   peak are printed from that pass, which has no stage timers. The fit
   runs the node-level rule, which takes both the PCA's and the GMM's
   choice from the analyzer's shapes (no sample: SIFT runs on the 768
   images alone) and must keep the distributed column PCA; its seconds
   per node and the device memory it leaves allocated are printed. A
   second
   fit + apply then times each stage, the card synchronized around every
   stage call; its seconds per stage are printed, and its totals apart.
4e. The cost-model solver choice on the CIFAR path (phase 4's data,
   filters, 8192 features after the scaler, lam = 10):
   - resident: ``LeastSquaresEstimator`` through ``Pipeline.fit``, where
     the node-level rule chooses from the analyzer's (n, d, k) and
     structural density (``fused_cifar_featurize`` launched for the fit
     alone; the sampled path is driven in 4p) and must splice Densify ->
     ``BlockLeastSquaresEstimator(1000, 3)``; its test error in phase 4's
     bands, its weights against the float64 BCD of its own input;
   - the candidates (dense L-BFGS, BCD(1000, 3), exact) fitted on the
     same scaled matrix, and the exact solver and BCD at LinearPixels'
     1024 features, each fit's seconds beside its EC2 cost, and whether
     the cost order is the measured order (printed, not asserted); the
     test error of each candidate at 8192 features, of phase 4's BCD(4096,
     1) and of the float64 exact ridge solve, beside how far each fit's
     weights lie from that solve (printed);
   - sparse: seeded host SparseVectors at (20480, 8192) and 1% density
     with 10-class labels, through the same rule, which must splice
     Sparsify -> ``SparseLBFGSwithL2``; weights against the dense L-BFGS
     on the densified copy at lam = 1, the same bits on a second fit, and
     at lam = 10 the weights against the exact float64 solve, where the
     JAX package's solver stops as far from it;
   - streamed: the same pipeline over chunks of 1024; the stream's n is
     known, so the rule's static path must choose the resident choice
     among the one-pass solvers, with ``gram_cross`` once per chunk; weights against the resident
     fit's and against the float64 Gram-form solve, test errors within
     0.01.
4f. MnistRandomFFT through ``run`` at the app's published width (200
   FFT branches, 102,400 features, blocks of 2048, lam = 1e-2) on
   16,384 / 2,048 surrogate MNIST images: train error at most 0.05,
   finite scores, and the block weights against a float64 BCD with the
   same blocks and pass on the fit's own features; fit and apply
   seconds, images/s, the fit's device-memory peak (beside the peak
   before map and gather fusion) and the optimizer's host seconds (its
   executions, CSE passes and fusion rule applications) inside the fit
   and the apply are printed (phase 4c prints the latter for its traffic
   too). The fit path's 600 branch nodes must be one fused featurizer
   node after the optimizer.
4g. TIMIT through ``run`` at the app's published width (50 cosine
   branches of 4096, 204,800 features, BlockLeastSquares(4096, 5, lam),
   147 classes) on 16,384 / 2,048 surrogate frames (gamma 1/880, lam
   1e-2, as ``bench.py::timit_bench`` sets them): one fused featurizer
   node on the fit path, the test error inside (0.02, 0.90), finite
   scores, and, against a float64 BCD (same blocks and passes, computed
   block by block) on the fit's own features, the block weights no
   worse than 2x the same BCD's in float32 and the training scores
   within 5e-3; fit and
   apply seconds, frames/s, the fit's peak and the optimizer's host
   seconds are printed.
4h. RandomCifar through ``run`` at its published defaults (100 Gaussian
   filters, patch 6, pool 14 / 13, alpha 0.25, exact solve) on phase 4's
   surrogate: the test error inside (0.02, 0.90), printed beside
   LinearPixels'; the featurizer one ``Fused[Convolver >>
   SymmetricRectifier >> Pooler >> ImageVectorizer]`` node; the same
   predictions under the DefaultOptimizer and the NoOpOptimizer; fit and
   apply seconds printed.
4i. Auto-caching: phase 4's RandomPatchCifar composed without its
   Cachers, fitted and applied under the DefaultOptimizer and under the
   greedy ``AutoCachingOptimizer`` in turn: the same predictions, and a
   budget of 75% of the free memory the card reports; the budget, each
   node's extrapolated profile, the cached set, the featurize kernel's
   launches in each fit and the fit and apply seconds are printed.
4j. ImageNetSiftLcsFV through ``build_pipeline`` / ``fit`` / apply at
   its published widths (SIFT step 4, bin 6, 5 scales, scale_step 1;
   LCS stride 4, border 16, sub-patch 6; 64-dim PCAs and 16-component
   GMMs on 10^7 sampled descriptors each; 4,096 features;
   BlockWeightedLeastSquares(4096, 1, 6e-5, 0.25) over 1000 classes;
   top 5) on ``make_surrogate_imagenet``'s uint8 images at 480 x 640
   (INET_TRAIN / INET_TEST). Every SIFT application must launch
   ``banded_matmul`` 10 times and every Fisher vector of either branch
   ``fv_moments`` once; the solver must run "woodbury"; the test top-5
   error must beat a seeded random score matrix's by 0.30; the fitted
   weights must lie within 5e-3 of the same solver's float64 weights on
   the same features, and the top-5 sets agree with the float64 model's
   on 99% of the test images. Fit and apply seconds, images/s, the
   device-memory peak and the launches are printed from that pass; an
   instrumented second pass gives the seconds per stage (SIFT, LCS, the
   PCA fits, the GMM fits, FV, the solve). Then the weighted solve at
   the rehearsal shape (randn X of 4096 x 4096, 1000 classes drawn at
   random), "woodbury" and "cholesky" each in float32 and float64: the
   two within 1e-8 of the largest weight of each other in float64, each
   float32 fit's training scores within 1.5e-2 of the largest float64
   score with the same argmax on 99% of the rows; each one's seconds,
   peak and class chunk printed, and each float32 path's distance from
   float64 (see REHEARSAL_SCORE_TOL for why the weights are not held).
4k. RandomPatchCifarAugmented at its published defaults (100 filters,
   patch 6, pool 14 / 13, alpha 0.25, lam 0, 10 random 24 x 24 patches
   an image, flips at 0.5, 10 center / corner test patches an image
   averaged) on phase 4's surrogate, the training set cut to AUG_TRAIN
   images: the test error inside (0.02, 0.90), printed beside phase
   4h's RandomCifar error with the fit and apply seconds and the fit's
   peak.
4l. Resilience and telemetry on phase 4b's streamed fit at full width,
   fitted through ``Estimator.fit`` / ``LabelEstimator.fit`` with stream
   options: an uninterrupted fit (the same bits as 4b's pipeline
   weights, a TelemetrySampler at 0.1 s beside it); the solver's fit
   killed at chunk 10 under a fault plan with a snapshot every 4 chunks
   (cursor 8 on disk) and resumed under a trace: the same bits,
   gram_cross launched 20 - 8 times, one restore, the snapshot gone;
   seeded transient staging faults (the default retry policy exhausts
   with a post-mortem, five attempts give the same bits); a NaN in chunk
   5's first pixel raising NumericsError naming the chunk within the
   deferral window, with the health series in its post-mortem; the
   numerics plane's overhead as the median of interleaved on/off pairs;
   a traced pipeline fit's Chrome trace with stage, stall, accumulate
   and node spans on their lanes. Checkpoint and restore seconds are
   printed beside the card's name and power limit.
4n. The loaders, from archives to the device (written under the run's
   temporary directory, read back only through the port's loaders and
   entry points): (a) right after 4d, its surrogate rounded to uint8 as
   JPEG at quality 90 in tars under ``VOCdevkit/VOC2007/JPEGImages/``
   with a labels CSV, through ``python -m keystone_tpu_torch
   voc.sift_fisher`` in process at the published defaults: the MAP in
   4d's band, 4d's launches exactly, and a sample of loaded items equal
   to PIL's decode of their bytes with the surrogate's labels; (b)
   ``bench.py::loader_bench``'s path: 512 JPEGs of 128 x 128 in one tar,
   decode-only, serial (``iter_decoded_chunks``, a copy, SIFT) and
   streamed (``stream_tar_images``, uint8 wire, depth 2) images/s, the
   stall share, 49,152 wire bytes an image, and a truncated member
   quarantined with the other 512 delivered; (e) HOG and DAISY on a 375 x
   500 image (card against CPU, the same bits twice, ms an image) and
   the approximate PCA (the card's subspace against the CPU's, ms a
   fit); (d) after 4f, MnistRandomFFT through ``python -m
   keystone_tpu_torch mnist.random_fft`` from CSV files (4,096 / 1,024
   rows, 200 FFTs): train error at most 0.05, the parse seconds; (c)
   inside 4j, its 1,000 test images as JPEG tars through
   ``imagenet_loader`` and 4j's fitted predictor: the top-5 error below
   the random scores' - 0.30, 10,000 banded and 2,000 FV launches, and
   200 of them as PNG giving 4j's in-memory top-5 sets.
4o. The text and NLP apps on the card (written under the run's
   temporary directory): (a) the surrogate 20 Newsgroups corpus at the
   "bydate" split sizes (TEXT_NEWS), one file a document in the 20news
   layout, through ``python -m keystone_tpu_torch text.newsgroups`` in
   process at the published defaults (bigrams, 100,000 common features,
   20 classes, naive Bayes with lam 1): the test error inside (0.02,
   0.90) and TEXT_RANDOM_MARGIN below a seeded random score matrix's;
   the naive Bayes sums, parameters and the scores of TEXT_SCORE_DOCS
   test documents the same bits on a second fit on the card from the
   fit's own inputs; the same documents through ``run(device="cpu")``
   in process: the same feature -> index map, scores within
   NB_CPU_SCORE_TOL of the largest, the same argmax; (b) surrogate
   Amazon reviews (TEXT_AMAZON) as JSON lines through
   ``text.amazon_reviews`` at the published defaults (bigrams, 100,000
   features, logistic regression, 20 iterations): the test error inside
   AMAZON_ERROR_BAND, the weights the same bits on a second fit, and within
   LR_F64_TOL of the largest from a float64 run of the same L-BFGS on
   the same CSR matrix with the same iteration count; (c)
   StupidBackoff through ``run`` at n = 3 on TEXT_BACKOFF_LINES Zipf
   lines: the scores equal to a ``device="cpu"`` run's; (d) the
   lemmatizing Newsgroups variant (perceptron POS and NER) on the first
   TEXT_LEMMA_DOCS training and test documents of (a); (e) the native
   host shim: built from ``native/keystone_native.cpp`` under
   ``build/keystone_tpu_torch/``, its n-gram hash features equal to the
   pure-Python ones on TEXT_HASH_DOCS documents of (a), and its branch
   counter showing the native branch served every hashing call. Each
   stage's seconds, documents/s, features, nnz, L-BFGS iterations and
   evaluations and scored n-grams/s are printed beside the card's name
   and power limit; none of the five kernels runs on this path.
4p. The static analyzer (after 4k): 4e's resident fit again with
   ``KEYSTONE_TORCH_STATIC_NODE_OPT=0``, the sampled path: provenance
   sampled, the static path's choice, one featurize launch more (the
   sample's); the node rule's choices on 4d and 4j, each static, with
   their banded and FV launches (no sample); ``check --all --json`` through
   ``__main__.main`` in process: exit 0, 11 apps clean, the device
   memory allocated unchanged and no launch; ``cifar.random_patch
   --trace-out`` at the bench configuration on phase 4's surrogate written
   as CIFAR binary files: the featurize nodes' annotated kernel FLOPs
   equal to the wrapper's counted work, every annotated ``mfu`` in (0,
   1], a per-node MFU and bandwidth table; ``numerics`` on 4l's
   poisoned-chunk post-mortem (exit 0, chunk 5 named) and ``benchdiff``
   on ``BENCH_r02.json`` -> ``BENCH_r01.json`` (exit 2, the JAX
   command's). Phases 4, 4b, 4d and 4f also print the static plan's
   fit-path peak beside their measured fit peak (``_PlanProbe``); 4b's
   stream charge in the plan must equal ``static_plan_nbytes`` and hold
   its budget. 4e, 4d and 4j hold the node rule's default, the static
   path: their choices come from the analyzer's shapes, so 4e launches
   the featurize kernel for the fit alone and 4d and 4j run SIFT on no
   sample. The plans printed against the measured peaks are the
   memo-held ones (``plan_graph(memo_held=True)``, what the executor
   holds); ``check`` prints the JAX package's liveness.
4q. The tree-wide scans and the gates (after 4o): the concurrency and
   hot-path scans over ``keystone_tpu_torch/`` each timed, with no
   finding and the hot-path scan inside ``HOTPATH_SCAN_BUDGET_S``, and
   ``check --all --json`` in process carrying both keys; ``check --xla``
   on ``cifar.random_patch`` and ``voc.sift_fisher`` on the card (each
   per-item node run once on a zero item: its plan charge, the bytes it
   output and its allocation peak, as ``plan_vs_device``; the featurize
   and banded kernels launched); then ``python -m
   keystone_tpu_torch.tools.ci --device cuda --chaos-seeds 1`` in a
   subprocess: lint, ``check --all``, the advisory benchdiffs and the
   recompile, numerics, serving, chaos and fleet gates and the
   schedule suite, each stage's seconds printed; any failing stage fails
   the run. The chain's elastic gate is phase 4r(c).
4r. The multi-process world (after 4q): (a) ``cifar.random_patch``'s
   ``main`` in a 2-rank gloo world on the one card (two ranks cannot
   share a device under NCCL), from 4p's CIFAR binary files at phase 4's
   configuration: each rank fits its block of the training rows, the
   featurize kernel on its rows and the block solve's Grams through
   ``gram_cross`` summed over the ranks in rank order; test error within
   0.002 of phase 4's, predictions agreeing on >= 0.99 of phase 4's,
   weights within 5e-3 of the largest of the same ``main`` on the same
   files in one process (the files round the surrogate's pixels to
   bytes, so the app learns other filters than phase 4: its weights'
   distance to phase 4's is printed); each rank's launches and fit
   seconds and the backend printed. (b) Phase 4b's streamed fit
   (20 chunks of 1024, depth 2) in the same world, 10 chunks a rank
   through the world loop of ``fit_streaming``: ``gram_cross`` 10
   launches a rank, weights within 5e-3 of 4b's, the carry merge's
   seconds and ``coord.overlap_occupancy`` printed. (c) The elastic
   gate on the card (run by 4q's CI chain, its lines read back): a rank
   killed entering round 3 and at round 2's await, each relaunched to
   ``torch.equal`` weights, and a resume at world size 1 refused. (d) An
   NCCL world of 1 in this process: ``merge_carries``, the rank-sharded
   ``gram`` and ``sharded_apply`` of 4c's float32 and int8 models,
   ``torch.equal`` to the same calls without a world. Multi-rank NCCL
   needs more than one card and is not exercised here.
4s. The measurement and calibration tools (after 4r): (a)
   ``tools.calibrate_cost_model`` at full size into the run's directory:
   the card's four weights beside the EC2 ones, each validation shape's
   three measured times, host synchronizations and the model's pick, the
   agreement; when an artifact was written, ``load_calibration`` of it
   must report ``source == "artifact"`` with those weights, and when the
   agreement is at most half, no artifact may exist. (b) The card's
   weights applied (printed, not asserted): a ``LeastSquaresEstimator``'s
   choice at 4e's resident and streamed shape beside the EC2 choice and
   beside the candidate 4e measured fastest, and each app's optimizable
   node's choice from ``check``'s static shapes under both weight sets.
   (c) ``tools.profile_solver`` at (50000, 4096, 10). (d)
   ``tools.profile_imagenet`` at 16 images of 480 x 640: each stage's
   device ms, host wall ms, launches and idle share, its kernel gates
   asserted; its launches join the kernels line's paths. (e)
   ``tools.elastic_bench`` with 2 gloo ranks on the card, its five metric
   lines printed with a ``[4s]`` prefix. The run pins
   ``KEYSTONE_TORCH_COST_CALIBRATION`` to a path in its own directory
   that does not exist, so that an artifact an earlier run of the tool
   left in the checkout cannot move 4e's and 4p's asserted choices.
4t. The members that complete the JAX package's surface (after 4s), on
   the objects phases 4 and 4f fitted: (a) phase 4's training features
   (its featurizer and scaler, centered by the block model's feature
   means) and +-1 labels through ``BlockLeastSquaresEstimator.
   compute_cost`` at the fitted blocks, and ``LinearMapEstimator.
   compute_cost`` at their concatenation, each within 1e-4 relative of a
   float64 evaluation of the same objective; (b) ``BlockLinearMapper.
   apply_and_evaluate`` over phase 4's test features split at the
   model's block bounds, the test error after each block printed, the
   last partial within ``rtol = atol = 2e-3`` of ``apply``'s output and
   its error within one test image of phase 4's; (c) phase 4f's
   MnistRandomFFT fit again under a ``PipelineTrace`` and an
   ``_OptimizerClock``: each rule's rewrites and host seconds from the
   trace's ``optimizer_rules``, its ``optimizer_runs``, as many as the
   clock's executions, and the fusion rules' rewrites at most their
   applications. The card's name and power limit on each line.
5. Timing: each kernel, its plain version and a library yardstick with
   CUDA events at the main path's shapes, one call at a time (the
   ``kernels`` line); for every kernel also the device time alone of the
   kernel and of its yardstick, replayed from a CUDA graph
   (``device_ms`` and ``library_device_ms`` in that line); each
   wrapper's host time a call, the featurize and quantized wrappers
   through the launch plans their nodes make once per model. Also the
   widened paths: featurize at 16 pooling regions, and ``fv_moments``
   at 4000 components (past the llh tile); and phase 4j's shapes: one
   480 x 640 image's 10 banded calls at scale_step 1, and ``fv_moments``
   at (64, 16) over 44,023 and 17,024 descriptors (the ``imagenet`` keys
   of the kernels line). Phase 3 holds those against their plain
   versions too.

``--profile`` adds a second resident fit + apply, a second streamed fit,
a serving burst and a second VOC test apply under ``torch.profiler`` and
prints device time by kernel and the device's idle share.

The line before the last is a JSON object listing every kernel (with its
launches on each phase's path, ``launches_by_path``); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import io
import json
import os
import pickle
import queue
import shutil
import statistics
import subprocess
import sys
import tarfile
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

#: phase -> (the node rule's choices, the phase's launches, its images),
#: filled by phases 4d and 4j and printed by phase 4p
RULE_RECORDS = {}

#: the kernels' work counts (FLOPs and bytes of a launch from its shapes)
#: and the bounds from the published H100 SXM peaks: one source, the
#: library's, which each wrapper counts its launches' work with
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from keystone_tpu_torch.ops.work import (  # noqa: E402
    PEAK_TF32_FLOPS,
    banded_work as _banded_work,
    bound as _bound,
    featurize_bound as _featurize_bound,
    fv_bound as _fv_bound,
    fv_work as _fv_work,
    gram_bound as _gram_bound,
    gram_work as _gram_work,
    quant_work as _quant_work,
)

#: Kernel vs plain version: max |kernel - plain| <= FEATURIZE_TOL *
#: max |plain|. The plain version runs in float32, the kernel's product
#: in 3xTF32 on centered patches (about float32's accuracy) and the rest
#: in float32, in another order (the JAX package holds its TPU kernel to
#: rtol = atol = 2e-3 against the composed ops).
FEATURIZE_TOL = 1e-5

#: the featurize kernel's product runs in 3xTF32 on centered patches: on
#: FEATURIZE_F64_B images its pooled features against float64 (the plain
#: version in float64) must be no worse than FEATURIZE_F64_RATIO x the
#: float32 plain version's error, and phase 4's test error must stay
#: within CIFAR_ERROR_DRIFT of the first sound reading (0.2371 on an H100,
#: float32 products)
FEATURIZE_F64_B, FEATURIZE_F64_RATIO = 256, 2.0
CIFAR_ERROR_FIRST, CIFAR_ERROR_DRIFT = 0.2371, 0.002

#: (patch size, channels, pool stride, pool size) held against the plain
#: version besides the main path's (6, 3, 13, 14): 9, 16 and 36 regions
#: (``--poolStride 7 --poolSize 8`` gives 16), patch size 9 on one
#: channel, four channels
FEATURIZE_GEOMETRIES = ((6, 3, 9, 10), (6, 3, 7, 8), (5, 3, 4, 8),
                        (9, 1, 13, 14), (6, 4, 13, 14))

#: Gram kernel vs plain version: max |kernel - plain| <= GRAM_TOL *
#: max |plain|. The plain version is cuBLAS in true float32 (TF32 off),
#: the kernel 3xTF32 on the tensor cores with float32 sums; the JAX
#: package holds its Gram kernel to rtol = atol = 2e-4, the ceiling here.
GRAM_TOL = 2e-4
#: the Gram kernel's products run in 3xTF32, the one exception to the
#: solver path's true float32. Against the float64 sums of the same
#: inputs into the same carry, its max error (G and C each) must be
#: within (GRAM_F64_ULPS + sqrt(slabs)) x 2^-24 of the largest float64
#: entry at every shape, for the ceil(n / kernels.gram_slab_rows())
#: slabs it sums: each slab's products accumulate on the tensor cores,
#: whose accumulator truncates (a bias of a few units of 2^-24), and the
#: slab sums are added with float32 rounding, a walk of sqrt(slabs).
#: Read on an H100 (PERF.md): 1.8-8.4 units at n <= 1024 (the plain
#: version 1.0-23.8), 25.9 at n = 20480; a split that truncates both
#: parts reads 16.4 at n = 1024 (keystone_tpu_torch/tools/time_gram.py),
#: over the bar (13.7). At the chunk shape, on seeded randn rows (phase
#: 3) and on the first training chunk featurized and scaled as the
#: streamed fit feeds it (phase 4b), it must also be no worse than
#: GRAM_F64_RATIO x the plain float32 version's error.
GRAM_F64_ULPS, GRAM_F64_RATIO = 8.0, 2.0

#: Quantized affine kernel vs plain version: max |kernel - plain| <=
#: QUANT_TOL * max |plain|. Both apply the same dequantized weights in
#: true float32 and differ only in the order of their sums.
QUANT_TOL = 1e-5

#: the serving phase: the plane's largest bucket (the JAX serve
#: command's default), client threads, small HTTP requests per model
SERVE_MAX_BATCH, CLIENTS, HTTP_REQUESTS = 64, 8, 32
#: quantized parity bars on the 4096 test images' scores: argmax
#: agreement with the f32 scores, max |delta| / max |f32 score|. The
#: error bars are those of tests/test_pallas_kernels.py:331-368; so is
#: int8's agreement bar. Its bf16 agreement bar (1.0 there, 0.999
#: planned here) was set on a separable teacher task: on this model the
#: bf16 weights, bit-identical to the JAX package's, flip 5 of 4096
#: near-tie images (0.9988; PERF.md, ROADMAP C4). So bf16 is held at
#: 0.998, and every flip, at either width, must be a near tie: an image
#: whose f32 top-2 margin is within twice the measured max |delta|.
QUANT_BARS = {"bf16": (0.998, 0.02), "int8": (0.98, 0.03)}

#: banded_matmul against its plain version: max |kernel - plain| <=
#: BANDED_TOL * max |plain|. Both sum the same band entries in float32;
#: only the order differs (the dense plain product adds the zeros too).
BANDED_TOL = 1e-5
#: fv_moments against its plain version: max |kernel - plain| <= FV_TOL *
#: max |plain| per output. The plain version writes the posteriors out
#: and takes its exponentials and sums in another order; the kernel runs
#: both products in 3xTF32 on centered terms.
FV_TOL = 1e-4
#: the wide FV at an image's descriptor count is held to FV_TOL on the
#: descriptors whose float64 posteriors all lie more than FV_CLEAR (in
#: log) from the threshold: float32 rounding moves a log-posterior by
#: about 1e-5, so closer ones can flip across it
FV_CLEAR = 1e-3

REPO = os.path.dirname(os.path.abspath(__file__))

SEED = 0
N_TRAIN, N_TEST = 20480, 4096
NUM_FILTERS = 1024
#: the streamed path's chunking, as the JAX package's streamed bench
CHUNK, DEPTH = 1024, 2
#: the solve ``build_pipeline`` runs: BlockLeastSquaresEstimator(4096, 1,
#: lam), two 4096-wide blocks, one pass
BLOCK, PASSES = 4096, 1
#: phase 4l: interleaved fit pairs, numerics plane on and off, whose
#: median share is printed (one fit reads 0.23-0.42 s on a shared host)
NUMERICS_PAIRS = 9

#: VOCSIFTFisher: surrogate train / test images (VOC2007 has 5,011
#: trainval and 4,952 test images; PERF.md lists the cut), the GMM at
#: full width, the 8 test images held kernel against plain
VOC_TRAIN, VOC_TEST, VOC_CHECK = 512, 256, 8
#: the test MAP must beat a seeded random score matrix's MAP on the same
#: labels by this margin, about 3x below the first sound reading (0.9707
#: against 0.1311 on an H100), and stay within VOC_MAP_DRIFT of that
#: reading
VOC_MAP_MARGIN = 0.28
VOC_MAP_FIRST, VOC_MAP_DRIFT = 0.9707, 0.01
#: Fisher vectors of the kernel path against float64: max |delta| / max.
#: The moment form fv2 = (s2 - 2 m s1 + (m^2 - v) s0) / (v sqrt(2 w))
#: cancels where the uncentered PCA'd descriptors are large against a
#: component's spread, so float32 sums in any order move it far more than
#: the sums themselves move
FV64_TOL = 1e-2
#: images in the --profile VOC apply
VOC_PROFILE = 32

#: Limits on the full-width solves, each max |a - b| / max |b|, set about
#: 3x above the readings of sound runs on an H100 (PERF.md): streamed
#: weights against resident weights, both float32 (read 1.561e-3) ...
W_STREAM_RESIDENT_TOL = 5e-3
#: ... each float32 fit against the float64 solve of its own input (read
#: 1.433e-3 resident, 7.93e-4 streamed) ...
W_FLOAT64_TOL = 5e-3
#: ... and the streamed fit, whose Gram products run in 3xTF32, no worse
#: than W_STREAMED_F64_RATIO x the streamed reading with the float32 Gram
#: kernel: W_STREAMED_F64_FLOAT32, read on an H100 80GB HBM3 at 700 W
#: with the true float32 kernel (PERF.md)
W_STREAMED_F64_FLOAT32, W_STREAMED_F64_RATIO = 9.163e-4, 2.0
#: ... and the Gram-form BCD against the data-form BCD, both in float64
#: on the same input (read 6.1e-11): equal in exact arithmetic, so only
#: float64 rounding amplified by the blocks' conditioning remains
GRAM_FORM_FLOAT64_TOL = 2e-10

#: Phase 4e, the cost-model solver choice: the candidates the reference's
#: EC2 surface ranks at the CIFAR path's width and at LinearPixels'
#: (n, d, k), timed on the same matrices; the sparse dataset's shape and
#: density; its L2 weight, where the sparse and the dense L-BFGS both
#: reach their optimum before the relative-improvement stop (9.4e-5 apart
#: on an H100 at lam = 1), and the bar of the sparse fit against the dense
#: fit on the densified copy there, max |delta| / max |W_dense|. At the
#: CIFAR path's lam = 10 the stop ends the sparse fit 1.410e-3 of the
#: largest weight from the exact solve in the JAX package as in the port,
#: on these data (tests/test_torch_solver_choice.py::
#: test_sparse_lbfgs_stops_where_jax_does_at_heavy_l2; ROADMAP C10), so
#: the bar there is on the distance from the exact solve, just above it
SOLVER_BLOCK, SOLVER_PASSES = 1000, 3
#: the resident choice's test error stays within SOLVER_ERROR_DRIFT of its
#: first sound reading (H100 80GB HBM3, 700 W; PERF.md): at lam = 10 three
#: passes of 1000-wide blocks end further from the exact ridge solve than
#: phase 4's one pass of 4096-wide blocks (2.30 of the largest weight
#: against 0.85), and the choice reads 0.0483 above it on this surrogate
SOLVER_ERROR_FIRST, SOLVER_ERROR_DRIFT = 0.2854, 0.002
SPARSE_N, SPARSE_D, SPARSE_NNZ, SPARSE_LAM = N_TRAIN, 8192, 82, 1.0
SPARSE_DENSE_TOL, SPARSE_HEAVY_L2_TOL = 1e-3, 1.5e-3

#: Phase 4f, MnistRandomFFT at the app's published width (200 FFT
#: branches of 512 features, blocks of 2048, bench.py's lam) on the
#: bench's surrogate, cut from 60,000 / 10,000 images as
#: ``bench.py::mnist_bench`` cuts it; its weights against a float64 BCD
#: with the same blocks and pass on the fit's own features, max |delta| /
#: max |W64| (phase 4b's bar); the train-error bar (no bar on the test
#: error: with as many features as images or more, this surrogate does not
#: generalise under a one-pass BCD)
MNIST_TRAIN, MNIST_TEST, MNIST_FFTS = 16384, 2048, 200
MNIST_BLOCK, MNIST_LAM = 2048, 1e-2
MNIST_F64_TOL, MNIST_TRAIN_ERROR = 5e-3, 0.05
#: the fit's device-memory peak before map and gather fusion (H100 80GB
#: HBM3, 700 W; PERF.md), printed beside this run's
MNIST_PEAK_UNFUSED_GIB = 42.68

#: Phase 4g, TIMIT at the app's published width (50 cosine branches of
#: 4096, 204,800 features, BlockLeastSquares(4096, 5, lam), 147 classes)
#: on ``bench.py::timit_bench``'s surrogate frames, cut from TIMIT's ~1.1M
#: training frames as the bench cuts them, with the bench's gamma and lam
#: for the surrogate's scale; the test error's band. Against a float64
#: BCD with the same blocks and passes on the fit's own features: the
#: weights no worse than TIMIT_F64_RATIO x those of the same BCD written
#: out in float32, and the training scores, max |delta| / max |P64|,
#: within TIMIT_SCORE_TOL (phase 4b's bar). At gamma 1/880 the cosine
#: features are near-linear in the frames, so each block's Gram is
#: ill-conditioned and five float32 passes leave the weights far from
#: float64 along its weak directions (7.373e-2 on an H100, PERF.md),
#: where the scores barely move
TIMIT_TRAIN, TIMIT_TEST, TIMIT_COSINES = 16384, 2048, 50
TIMIT_GAMMA, TIMIT_LAM, TIMIT_EPOCHS = 1.0 / 880, 1e-2, 5
TIMIT_F64_RATIO, TIMIT_SCORE_TOL = 2.0, 5e-3
TIMIT_ERROR_BAND = (0.02, 0.90)

#: Phase 4h, RandomCifar at its published defaults (100 filters, patch
#: 6, pool 14 / 13, alpha 0.25, the exact solve with lam None) on phase
#: 4's surrogate; the surrogate's test-error band
RC_ERROR_BAND = (0.02, 0.90)

#: Phase 4j, ImageNetSiftLcsFV at its published widths
#: (``keystone_tpu/pipelines/images/imagenet/sift_lcs_fv.py:48-73``) on
#: ``make_surrogate_imagenet``'s 480 x 640 images over 1000 classes, top 5,
#: cut from ImageNet's 1.28M / 50k images (PERF.md lists the cut). The
#: test top-5 error must beat a seeded random score matrix's by
#: INET_RANDOM_MARGIN; the fitted weights must lie within INET_F64_TOL of
#: the largest weight of the same solver run in float64 on the same
#: features, and the top-5 sets agree with that model's on INET_TOP_AGREE
#: of the test images
INET_TRAIN, INET_TEST, INET_CLASSES, INET_TOP_K = 1024, 1000, 1000, 5
INET_H, INET_W = 480, 640
INET_LAM, INET_MIXTURE = 6e-5, 0.25
INET_RANDOM_MARGIN, INET_F64_TOL, INET_TOP_AGREE = 0.30, 5e-3, 0.99
#: the FV kernel's descriptor counts on 4j's path: 44,023 SIFT descriptors
#: (5 scales, scale_step 1) and 112 x 152 LCS keypoints of a 480 x 640 image
INET_FV_N = (44023, 17024)

#: Phase 4n, the tar and CSV loaders on the card: phase 4d's and 4j's
#: surrogate images as JPEG at JPEG_QUALITY in VOC_TARS (train, test) and
#: INET_TARS tars (and 4j's first INET_PNG test images as PNG, whose
#: top-5 sets must be the in-memory apply's); bench.py::loader_bench's
#: streamed tar -> SIFT path
#: (LOADER_N JPEGs of LOADER_SIDE x LOADER_SIDE in one tar, chunks of
#: LOADER_CHUNK, prefetch depth LOADER_DEPTH, medians of LOADER_REPS
#: passes) and LOADER_SAMPLE VOC items held against PIL; MnistRandomFFT
#: from CSVs cut to MNIST_CSV_TRAIN / MNIST_CSV_TEST rows, so that the
#: parse stays near a second (phase 4f keeps the full depth in memory).
#: HOG and DAISY on the card against the same code on the CPU, both in
#: float32 in other summation orders, at features of at most 1:
#: HOG_DAISY_TOL absolute (2.4e-7 read against the JAX package on the
#: CPU, tests/test_torch_image_nodes.py). The approximate PCA on seeded
#: (APCA_N, APCA_D) rows with spectrum APCA_DECAY^i: the card's and the
#: CPU's projectors within APCA_TOL (a float32 fit reads 7.5e-7 from a
#: float64 one on the CPU)
JPEG_QUALITY = 90
VOC_TARS, INET_TARS, INET_PNG = (4, 2), 4, 200
LOADER_N, LOADER_SIDE, LOADER_CHUNK, LOADER_DEPTH = 512, 128, 64, 2
LOADER_REPS, LOADER_SAMPLE = 3, 16
MNIST_CSV_TRAIN, MNIST_CSV_TEST = 4096, 1024
HOG_DAISY_TOL = 1e-5
APCA_N, APCA_D, APCA_DIMS, APCA_DECAY, APCA_TOL = 131072, 128, 80, 0.95, 1e-4
#: the weighted solve at the rehearsal shape (bench.py:1131, 1217-1230):
#: randn X (n, d), labels drawn at random over INET_CLASSES. The JAX
#: package holds "woodbury" against "cholesky" within 2e-3 of the largest
#: weight (tests/test_weighted_solvers.py:114-133, at lam 0.3). At this
#: shape, n = d and lam = 6e-5, M = (1-w) pop_cov + lam I has condition
#: number 4.98e4 (eigenvalues 6e-5 to 2.99), and float32 rounding moves
#: each path's weights far from its float64 solve (woodbury 3.57e-2,
#: cholesky 1.28e-2; the two in float32 3.59e-2 apart) while the two
#: paths in float64 agree to 7.3e-10 (H100 80GB HBM3, 700 W; PERF.md).
#: So the paths are held to each other in float64 (the algebra), and each
#: float32 fit's training scores to the float64 solve's: within
#: REHEARSAL_SCORE_TOL of the largest score (read 4.5e-3 woodbury, 1.4e-3
#: cholesky) with the same argmax on REHEARSAL_ARGMAX_AGREE of the rows
REHEARSAL_N, REHEARSAL_D = 4096, 4096
REHEARSAL_F64_TOL, REHEARSAL_SCORE_TOL, REHEARSAL_ARGMAX_AGREE = (
    1e-8, 1.5e-2, 0.99)

#: Phase 4k, RandomPatchCifarAugmented at its published defaults on phase
#: 4's surrogate, the training set cut to its first AUG_TRAIN images (10
#: patches each; PERF.md gives the memory reason); the test error's band
AUG_TRAIN, AUG_ERROR_BAND = 4096, (0.02, 0.90)

#: Phase 4i: the greedy auto-cache budget must be 75% of the free device
#: memory read beside it, within this many bytes (the driver reports free
#: memory in whole pages)
AUTO_CACHE_BUDGET_SLACK = 2 * 2**20


#: Phase 4o, the text apps: the 20 Newsgroups "bydate" split sizes; the
#: test documents whose scores are held card against card and card
#: against CPU; Amazon reviews, cut from the dataset's millions for the
#: host featurizer's time (about 0.5 ms a document in Python); the
#: StupidBackoff corpus's lines; the lemmatized and the hashed documents
TEXT_NEWS = (11_314, 7_532)
TEXT_SCORE_DOCS = 256
TEXT_AMAZON = (65_536, 16_384)
TEXT_BACKOFF_LINES = 40_000
TEXT_LEMMA_DOCS = 1_024
TEXT_HASH_DOCS = 1_000
#: the test error must beat a seeded random score matrix's by this margin
TEXT_RANDOM_MARGIN = 0.30
#: the Amazon test error's band. The surrogate review draws binomial(10,
#: 0.6) words of its polarity's 60-word window, 30 of which the other
#: polarity shares, so a review all of whose own words are shared cannot
#: be told apart: the Bayes error is 0.5 x (0.4 + 0.6 / 2)^10 = 0.0141,
#: and a fit on 65,536 reviews comes near it. The lower end sits below
#: it: a lower reading would mean the labels leaked into the features.
AMAZON_ERROR_BAND = (0.01, 0.90)
#: naive Bayes scores of the card's fit against the CPU's, max |delta| /
#: max |score|: float64 sums of term presences are exact on both, and the
#: float32 scoring gathers sum ~80 terms in another order
NB_CPU_SCORE_TOL = 1e-5
#: the float32 logistic regression against the same L-BFGS in float64 on
#: the same CSR matrix and iteration count, max |delta| / max |W64|
LR_F64_TOL = 5e-3


def _sync():
    torch.cuda.synchronize()


def _events_ms(fn, reps=20):
    """Mean milliseconds of ``fn`` over ``reps`` calls enqueued back to
    back between two CUDA events: device time where the calls' host time
    is shorter than their work (a CUDA graph's replay, which
    ``tools.device_ms`` cannot capture again)."""
    fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _time_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    _sync()
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


def _featurize_inputs(rng, B, K, device, S=6, C=3):
    F = S * S * C
    imgs = torch.as_tensor((rng.rand(B, 32, 32, C) * 255).astype(np.float32),
                           device=device)
    filters = torch.as_tensor((rng.randn(K, F) * 0.1).astype(np.float32),
                              device=device)
    means = torch.as_tensor((rng.randn(F) * 20).astype(np.float32),
                            device=device)
    return imgs, filters, means














def _host_us(fn, reps=50):
    """Microseconds of host time a call of ``fn``: ``reps`` calls enqueued
    back to back (the device's queue does not fill at these counts), then
    the card synchronized outside the clock."""
    fn()
    _sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e6
    _sync()
    return host


def _gram_f64_bar(kernels, n):
    """The Gram kernel's bar against float64 for n rows, relative to the
    largest float64 entry (GRAM_F64_ULPS)."""
    slabs = -(-n // kernels.gram_slab_rows())
    return (GRAM_F64_ULPS + slabs ** 0.5) * 2.0 ** -24


def _gram_float64(kernels, X, Y, G0, C0, label, ratio=True):
    """gram_cross and its plain version on the same X, Y into the same
    carry G0, C0, each held against the float64 sums: asserts the
    kernel's max error is within ``_gram_f64_bar`` and, with ``ratio``,
    no worse than GRAM_F64_RATIO x the plain version's, for G and for C."""
    G, C = kernels.gram_cross(X, Y, G0.clone(), C0.clone())
    plain_G, plain_C = kernels.gram_cross_plain(X, Y, G0.clone(), C0.clone())
    Xd = X.double()
    want_G = torch.addmm(G0.double(), Xd.T, Xd)
    want_C = torch.addmm(C0.double(), Xd.T, Y.double())
    for name, got, plain, want in (("G", G, plain_G, want_G),
                                   ("C", C, plain_C, want_C)):
        scale = float(want.abs().max())
        k_err = float((got.double() - want).abs().max()) / scale
        p_err = float((plain.double() - want).abs().max()) / scale
        bar = _gram_f64_bar(kernels, X.shape[0])
        print(f"[check] gram_cross {label} {name} against float64: kernel "
              f"(3xTF32) {k_err:.3e}, plain float32 {p_err:.3e} of the "
              f"largest entry ({k_err / max(p_err, 1e-30):.2f}x); "
              f"{k_err * 2 ** 24:.2f} units of 2^-24 (bar "
              f"{bar * 2 ** 24:.2f})", flush=True)
        assert k_err <= bar, (label, name, k_err, bar)
        assert not ratio or k_err <= GRAM_F64_RATIO * p_err, \
            (label, name, k_err, p_err)
    del G, C, plain_G, plain_C, Xd, want_G, want_C


def _check_gram(kernels, rng, dev):
    """gram_cross against its plain version at the streamed path's chunk
    shape (into a nonzero carry, and against float64 there), small ragged
    shapes at the tile edges and LinearPixels' width, with the same bits
    on a second launch; returns the largest absolute error."""
    worst = 0.0
    for n, d, k, carry in ((CHUNK, NUM_FILTERS * 8, 10, True),
                           (1000, 100, 3, False), (7, 3, 2, False),
                           (33, 129, 17, True), (1000, 255, 16, False),
                           (N_TRAIN, 3072, 10, False)):
        X = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=dev)
        Y = torch.as_tensor(rng.randn(n, k).astype(np.float32), device=dev)
        G0 = torch.zeros((d, d), device=dev)
        C0 = torch.zeros((d, k), device=dev)
        if carry:
            # a carry of the size one earlier chunk would have left
            G0 = torch.randn((d, d), device=dev) * n ** 0.5
            G0 = G0 + G0.T
            C0 = torch.randn((d, k), device=dev) * n ** 0.5
        G, C = kernels.gram_cross(X, Y, G0.clone(), C0.clone())
        G2, C2 = kernels.gram_cross(X, Y, G0.clone(), C0.clone())
        want_G, want_C = kernels.gram_cross_plain(X, Y, G0.clone(),
                                                  C0.clone())
        _sync()
        assert bool(torch.isfinite(G).all()) and bool(torch.isfinite(C).all())
        assert torch.equal(G, G.T), "gram_cross: G is not symmetric"
        assert torch.equal(G, G2) and torch.equal(C, C2), \
            "gram_cross: a second launch gave other bits"
        # the ratio to the plain version is held at the chunk shape
        _gram_float64(kernels, X, Y, G0, C0,
                      "randn rows" if n == CHUNK else f"n={n} d={d} k={k}",
                      ratio=n == CHUNK)
        for name, got, want in (("G", G, want_G), ("C", C, want_C)):
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            print(f"[check] gram_cross n={n} d={d} k={k}"
                  f"{' (nonzero carry)' if carry else ''} {name}: max abs "
                  f"err {err:.3e} (max |plain| {scale:.3e}, rel "
                  f"{err / scale:.3e})", flush=True)
            assert err <= GRAM_TOL * scale, (name, err, scale)
            worst = max(worst, err)
        del X, Y, G0, C0, G, C, G2, C2, want_G, want_C
    torch.cuda.empty_cache()
    return worst


def _quant_inputs(rng, n, d, k, weight_dtype, dev):
    from keystone_tpu_torch.nodes.learning.linear import _quantize_weights

    X = torch.as_tensor(rng.randn(n, d).astype(np.float32), device=dev)
    W = torch.as_tensor((rng.randn(d, k) * 0.01).astype(np.float32),
                        device=dev)
    Wq, scale = _quantize_weights(W, weight_dtype)
    mean, inv, b = (torch.as_tensor(v.astype(np.float32), device=dev)
                    for v in (rng.randn(d), 1.0 + rng.rand(d), rng.randn(k)))
    return X, Wq, scale, mean, inv, b


def _check_quant(kernels, rng, dev):
    """quantized_affine against its plain version, bf16 and int8, at the
    served shapes (a request of one, a full bucket, the 4096-image batch
    apply), a ragged shape, a wide k and the column variants k = 1, 16
    and 17, each through the model's launch plan as the path calls it:
    one launch a call, the same bits on a second call. Returns the
    largest absolute error."""
    worst = 0.0
    for n, d, k in ((1, 8192, 10), (SERVE_MAX_BATCH, 8192, 10),
                    (N_TEST, 8192, 10), (77, 50, 11), (33, 1000, 1000),
                    (SERVE_MAX_BATCH, 8192, 1), (SERVE_MAX_BATCH, 8192, 16),
                    (SERVE_MAX_BATCH, 8192, 17)):
        for wd in ("bf16", "int8"):
            args = _quant_inputs(rng, n, d, k, wd, dev)
            plan = kernels.quant_plan(*args[1:])
            before = kernels.LAUNCHES["quantized_affine"]
            got = kernels.quantized_affine(args[0], plan)
            assert kernels.LAUNCHES["quantized_affine"] == before + 1
            again = kernels.quantized_affine(args[0], plan)
            want = kernels.quantized_affine_plain(*args)
            _sync()
            assert got.shape == want.shape == (n, k)
            assert bool(torch.isfinite(got).all())
            assert torch.equal(got, again), (wd, n, d, k)
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            splits, dsplit = plan.split(n)
            print(f"[check] quantized_affine {wd} n={n} d={d} k={k} (columns "
                  f"{plan.kc}, {splits} splits of d): max abs err {err:.3e} "
                  f"(max |plain| {scale:.3e}, rel {err / scale:.3e})",
                  flush=True)
            assert err <= QUANT_TOL * scale, (wd, n, d, k, err, scale)
            worst = max(worst, err)
    return worst


def _nan_cases(kernels, sift, dev):
    """One input with a single NaN for each kernel, at a shape its path
    gives it: (name, kernel call, plain call, reach), reach None where the
    kernel's non-finite outputs must be the plain version's, else the call
    giving the banded kernels' own reach (``kernels.banded_live_reach``).
    The NaN sits in an image's first pixel, a feature, a served row, an
    image pixel inside the SIFT bands and a descriptor. Drawn from their
    own seed, so the other checks' inputs do not move."""
    rng = np.random.RandomState(SEED + 15)
    imgs, filters, means = _featurize_inputs(rng, 8, NUM_FILTERS, dev)
    imgs[0, 0, 0, 0] = float("nan")
    X = torch.as_tensor(rng.randn(CHUNK, 1024).astype(np.float32),
                        device=dev)
    Y = torch.as_tensor(rng.randn(CHUNK, 10).astype(np.float32), device=dev)
    X[7, 11] = float("nan")
    q_args = _quant_inputs(rng, SERVE_MAX_BATCH, 8192, 10, "int8", dev)
    q_args[0][3, 100] = float("nan")
    q_plan = kernels.quant_plan(*q_args[1:])
    q_params = tuple(q_args[1:]) if q_plan is None else (q_plan,)
    rand = np.zeros((500, 520), np.float32)
    for j in range(500):
        c = min(int(j * 1.04), 519)
        rand[j, max(0, c - 13):c + 14] = rng.randn(
            min(520, c + 14) - max(0, c - 13))
    Xb = torch.as_tensor(rng.rand(520, 777).astype(np.float32), device=dev)
    Xb[100, 50] = float("nan")
    (_, left, right, _), _ = _sift_contractions(sift, 375, 500, 0)
    Xs = torch.as_tensor(rng.rand(1, 375, 500).astype(np.float32),
                         device=dev)
    Xs[0, 100, 200] = float("nan")
    fv = _fv_inputs(rng, 80, 256, 4097, dev)
    fv[0][5, 100] = float("nan")
    return [
        ("fused_cifar_featurize",
         lambda: kernels.fused_cifar_featurize(imgs, filters,
                                               whitener_means=means),
         lambda: kernels.fused_cifar_featurize_plain(
             imgs, filters, whitener_means=means), None),
        ("gram_cross", lambda: kernels.gram_cross(X, Y),
         lambda: kernels.gram_cross_plain(X, Y), None),
        ("quantized_affine",
         lambda: kernels.quantized_affine(q_args[0], *q_params),
         lambda: kernels.quantized_affine_plain(*q_args), None),
        ("banded_matmul one-sided",
         lambda: kernels.banded_matmul(rand, Xb),
         lambda: kernels.banded_matmul_plain(rand, Xb),
         lambda: kernels.banded_live_reach(rand, Xb)),
        ("banded_matmul two-sided",
         lambda: kernels.banded_matmul(left, Xs, right=right),
         lambda: kernels.banded_matmul_plain(left, Xs, right=right),
         lambda: kernels.banded_live_reach(left, Xs, right=right)),
        ("fv_moments",
         lambda: kernels.fv_moments(*fv, 1e-4),
         lambda: kernels.fv_moments_plain(*fv, 1e-4), None),
    ]


def _check_nan(kernels, sift, dev):
    """Every kernel and its plain version on an input with one NaN. A
    kernel that turns a NaN into a finite value hides a poisoned input
    from the numerics tripwires downstream, so each kernel's non-finite
    outputs must lie where the plain version's do. Four kernels must give
    the plain version's exactly. The banded kernels sum over each tile's
    live range, as the TPU kernel does, so a NaN reaches the outputs
    whose range covers it (``kernels.banded_live_reach``), where the
    plain version's dense product reaches the whole column; they must
    give that reach exactly, inside the plain version's."""
    for name, kernel, plain, reach in _nan_cases(kernels, sift, dev):
        got, want = kernel(), plain()
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = want if isinstance(want, (tuple, list)) else (want,)
        bad = [~torch.isfinite(g) for g in got]
        bad_plain = [~torch.isfinite(w) for w in want]
        ref = bad_plain if reach is None else [reach()]
        _sync()
        n_got = sum(int(b.sum()) for b in bad)
        n_ref = sum(int(b.sum()) for b in ref)
        n_plain = sum(int(b.sum()) for b in bad_plain)
        same = all(torch.equal(b, r) for b, r in zip(bad, ref))
        inside = all(bool((b & ~p).sum() == 0)
                     for b, p in zip(bad, bad_plain))
        size = sum(g.numel() for g in got)
        what = ("plain" if reach is None
                else f"live-range reach {n_ref}, plain")
        print(f"[nan] {name}: one NaN in, non-finite outputs kernel {n_got}, "
              f"{what} {n_plain} of {size}, same positions as "
              f"{'plain' if reach is None else 'the reach'} {same}, inside "
              f"the plain version's {inside}", flush=True)
        assert n_got == n_ref and n_ref > 0, (name, n_got, n_ref)
        assert same and inside, (name, same, inside)


def _bcd_float64(A, Y, lam, bounds, passes, dtype=torch.float64):
    """Block coordinate descent in float64 (or ``dtype``), written out in
    the data form and independent of the port's solvers: center A and Y,
    then per pass and per block in order W_b <- (A_b^T A_b + lam I)^-1
    A_b^T (Y - P + A_b W_b), keeping P = A W. A may be float32: each block
    is cast to ``dtype`` (and centered) when it is used, so no float64
    copy of the whole of A is made. Over several passes each block's
    regularized Gram, which the passes share, is factored (Cholesky) in
    the first and its factor kept. Returns W and the centered scores P."""
    Y = Y.to(dtype)
    Y = Y - Y.mean(dim=0)
    W = torch.zeros((A.shape[1], Y.shape[1]), dtype=dtype, device=A.device)
    P = torch.zeros_like(Y)
    factors = {}
    for _ in range(passes):
        for lo, hi in bounds:
            Ab = A[:, lo:hi].to(dtype)
            Ab = Ab - Ab.mean(dim=0)
            rhs = Ab.T @ (Y - P + Ab @ W[lo:hi])
            if lo not in factors:
                reg = Ab.T @ Ab + lam * torch.eye(hi - lo, dtype=Ab.dtype,
                                                  device=A.device)
                if passes == 1:
                    new = torch.linalg.solve(reg, rhs)
                else:
                    factors[lo] = torch.linalg.cholesky(reg)
                del reg
            if lo in factors:
                new = torch.cholesky_solve(rhs, factors[lo])
            P += Ab @ (new - W[lo:hi])
            W[lo:hi] = new
            del Ab, rhs
    return W, P


def _float64_check(featurizer, fits, images, labels, lam, dev, block=BLOCK,
                   passes=PASSES):
    """The full-width solve of each fit redone in float64 on that fit's
    own input: the training set featurized by the fit's featurizer, in
    chunks of CHUNK images, and scaled in float32 by the fit's scaler,
    which is what its solver consumed. ``fits`` maps a name to
    ``(scaler, float32 weights)``; the solve is a BCD over blocks of
    ``block`` features, ``passes`` passes. Returns, per fit, max |W32 -
    W64| / max |W64|; the spread of the float64 solves between the fits'
    inputs (the scalers' float32 rounding alone); and, on the streamed
    fit's input, the port's Gram-form BCD (``gram_bcd``) against the data
    form, both in float64 (``gram_form``), and the streamed float32
    weights against that Gram-form solve (``streamed_gram``)."""
    from keystone_tpu_torch.nodes.learning.linear import gram_bcd

    F = torch.cat([featurizer.apply_batch(torch.as_tensor(
        images[i:i + CHUNK], device=dev)) for i in range(0, N_TRAIN, CHUNK)])
    Y = torch.where(torch.arange(10, device=dev) == torch.as_tensor(
        labels, device=dev)[:, None], 1.0, -1.0).to(torch.float64)
    d = F.shape[1]
    bounds = [(lo, min(d, lo + block)) for lo in range(0, d, block)]
    out, w64 = {}, {}
    for name, (scaler, W32) in fits.items():
        A = scaler.apply_batch(F).to(torch.float64)
        W, _ = _bcd_float64(A, Y, lam, bounds, passes)
        out[name] = float((W32.to(W) - W).abs().max() / W.abs().max())
        w64[name] = W
        if name == "streamed":
            carry = (A.T @ A, A.T @ Y, A.sum(dim=0), Y.sum(dim=0), N_TRAIN)
            Wg = torch.cat(gram_bcd(carry, lam, bounds, passes)[0])
            out["gram_form"] = float((Wg - W).abs().max() / W.abs().max())
            out["streamed_gram"] = float((W32.to(Wg) - Wg).abs().max()
                                         / Wg.abs().max())
            del carry, Wg
        del A
    a, b = w64.values()
    out["inputs"] = float((a - b).abs().max() / b.abs().max())
    del F, Y, w64, a, b
    torch.cuda.empty_cache()
    return out


def _serving_requests(images, seed):
    """The images cut, in order, into requests of seeded sizes 1-64."""
    rng = np.random.RandomState(seed)
    out, i = [], 0
    while i < len(images):
        n = int(rng.randint(1, SERVE_MAX_BATCH + 1))
        out.append(images[i:i + n])
        i += n
    return out


def _drive(plane, name, requests):
    """Send ``requests`` to model ``name`` through ``plane.submit`` from
    CLIENTS threads, each waiting on its answer before its next request.
    Returns the predictions in request order and the wall seconds."""
    results = [None] * len(requests)

    def client(j):
        for r in range(j, len(requests), CLIENTS):
            results[r] = plane.submit(name, requests[r]).result(timeout=120)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(CLIENTS) as pool:
        for fut in [pool.submit(client, j) for j in range(CLIENTS)]:
            fut.result(timeout=600)
    wall = time.perf_counter() - t0
    return np.concatenate(results), wall


def _post(base, path, payload):
    """POST JSON; returns (status, decoded body)."""
    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as rsp:
            return rsp.status, json.loads(rsp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"null")


def _serve_subprocess(model_path, images, want):
    """``python -m keystone_tpu_torch serve`` on the saved model at bf16:
    wait for its ready line, POST 4 requests of 1-4 images, hold the
    answers against ``want`` (the in-process bf16 predictions of the
    same images), stop it. Returns the lines it printed."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch", "serve",
         f"rpc={model_path}@32,32,3", "--port", "0", "--weight-dtype",
         "bf16"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    lines: "queue.Queue" = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line.rstrip())
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    seen = []
    try:
        deadline = time.time() + 300
        while not (seen and seen[-1].startswith("serving ready")):
            line = lines.get(timeout=max(deadline - time.time(), 1.0))
            if line is None:
                raise RuntimeError("serve exited before it was ready:\n"
                                   + "\n".join(seen))
            seen.append(line)
        assert seen[-1].startswith("serving ready (1 models)"), seen
        port = int(next(s for s in seen if s.startswith("serving on"))
                   .rsplit(":", 1)[1])
        i = 0
        for n in (1, 2, 3, 4):
            status, out = _post(f"http://127.0.0.1:{port}", "/predict/rpc",
                                {"instances": images[i:i + n].tolist()})
            assert status == 200, (status, out)
            assert np.array_equal(np.asarray(out["predictions"]),
                                  want[i:i + n]), (out, want[i:i + n])
            i += n
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return seen


def _path_launches(kernels):
    """The kernel launches since the last reset of both counts: the
    wrappers' own (eager calls and captures) plus every graph replay's
    recorded launches."""
    from keystone_tpu_torch.serving.graphs import REPLAYED_LAUNCHES

    out = dict(kernels.LAUNCHES)
    for name, count in REPLAYED_LAUNCHES.items():
        out[name] = out.get(name, 0) + count
    return out


def _pools_within_charge(what, held, charged):
    """The graph pools an admission holds lie within the pools its charge
    probed, and at most POOL_CHARGE_MARGIN below them."""
    assert 0 < held <= charged <= held * (1 + POOL_CHARGE_MARGIN), (
        what, held, charged)


def _serving_phase(kernels, model_path, te_x, te_y, preds, dev):
    """Phase 4c (see the module docstring). Returns the kernel launch
    counts of the traffic run."""
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.serving import (
        AdmissionError,
        ItemSpec,
        ModelNotAdmitted,
        ServingPlane,
        serve,
    )
    from keystone_tpu_torch.serving.batcher import BucketPolicy
    from keystone_tpu_torch.serving.fleet import canonicalize
    from keystone_tpu_torch.serving.graphs import reset_replayed_launches
    from keystone_tpu_torch.serving.plane import graph_rows
    from keystone_tpu_torch.utils.checkpoint import load_pipeline

    mib = 1 << 20
    saved = load_pipeline(model_path, device=dev)
    spec = ItemSpec((32, 32, 3), np.float32)
    rows = graph_rows(BucketPolicy(SERVE_MAX_BATCH), dev)
    models = {"rpc_f32": None, "rpc_bf16": "bf16", "rpc_int8": "int8"}
    # each model's charge as the plane will take it (the weight type
    # applied, its graphs' pools probed); the budget holds the three and
    # not a fourth
    ones = {name: canonicalize(saved, spec, wd, SERVE_MAX_BATCH, dev)[1]
            for name, wd in models.items()}
    budget = sum(ones.values()) + 0.5 * min(ones.values())
    reg = MetricsRegistry.get_or_create()
    plane = ServingPlane(hbm_budget=budget, max_batch=SERVE_MAX_BATCH,
                         device=dev).start()
    server = serve(plane, port=0)
    base = f"http://127.0.0.1:{server.server_port}"
    try:
        entries = {name: plane.admit(name, saved, spec, weight_dtype=wd)
                   for name, wd in models.items()}
        state = plane.state()
        charged = state["hbm_charged_bytes"]
        assert state["ready"] and len(state["models"]) == 3
        assert charged <= budget < charged + min(
            e.charge.total_nbytes() for e in entries.values()), state
        assert all(entries[n].charge.total_nbytes() == ones[n]
                   for n in models), (ones, state)
        # a fourth model whose charge is larger than the budget (its
        # item is wide: each captured bucket's static input is charged)
        # is refused, and nothing changes
        d = int(1.2 * budget / (4 * (SERVE_MAX_BATCH + sum(rows)))) + 1
        W = np.ones((d, 1), np.float32)
        big = BlockLinearMapper([W], d).to_pipeline()
        try:
            plane.admit("big", big, ItemSpec((d,), np.float32))
            raise AssertionError("an admission beyond the budget was taken")
        except AdmissionError as exc:
            print(f"[serve] fourth admission refused: {exc}", flush=True)
        refused = plane.state()
        assert [m["name"] for m in refused["models"]] == sorted(models)
        assert refused["hbm_charged_bytes"] == charged

        # traffic: the test set to each model from CLIENTS threads
        requests = _serving_requests(te_x, SEED)
        served, walls, peaks = {}, {}, {}
        _sync()
        kernels.reset_launches()
        reset_replayed_launches()
        unexpected0 = plane.unexpected_recompiles()
        batches0 = reg.counter("serving.batches_total").value
        for name in models:
            torch.cuda.reset_peak_memory_stats()
            served[name], walls[name] = _drive(plane, name, requests)
            peaks[name] = torch.cuda.max_memory_allocated()
        launches = _path_launches(kernels)
        wrapper_launches = dict(kernels.LAUNCHES)
        unexpected = plane.unexpected_recompiles() - unexpected0
        batches = {m["name"]: m["batches"] for m in plane.state()["models"]}
        total_batches = reg.counter("serving.batches_total").value - batches0
        assert sum(batches.values()) == total_batches, (batches,
                                                        total_batches)
        for name in models:
            h = reg.histogram(f"serving.request_ms.{name}")
            fill = reg.histogram(f"serving.batch_fill.{name}").mean
            e = entries[name]
            print(f"[serve] {name}: {N_TEST} rows in {walls[name]:.3f} s "
                  f"({N_TEST / walls[name]:.0f} rows/s), {len(requests)} "
                  f"requests in {batches[name]} batches (mean fill "
                  f"{fill:.3f}), request_ms p50 {h.percentile(50):.3f} p99 "
                  f"{h.percentile(99):.3f}, warmup {e.warmup_s:.3f} s, "
                  f"charge {e.charge.total_nbytes() / mib:.3f} MiB "
                  f"(model {e.charge.model_nbytes / mib:.3f} MiB + "
                  f"{e.charge.item_nbytes:.0f} B x {e.charge.bucket_rows}"
                  f" + graphs {e.charge.graph_nbytes / mib:.3f} MiB, of "
                  f"which pools {e.charge.pool_nbytes / mib:.3f} MiB, "
                  f"{e.charge.source}), {e.captures} captures in "
                  f"{e.capture_s:.3f} s holding "
                  f"{e.graph_pool_nbytes / mib:.3f} MiB of graph pools, "
                  f"device-memory peak {peaks[name] / mib:.1f} MiB",
                  flush=True)
            _pools_within_charge(name, e.graph_pool_nbytes,
                                 e.charge.pool_nbytes)
        print(f"[serve] budget {budget / mib:.3f} MiB, charged "
              f"{charged / mib:.3f} MiB; launches during traffic "
              f"{launches} (graph replays x the launches each capture "
              f"recorded, plus the wrappers' eager ones "
              f"{wrapper_launches}), "
              f"served batches {batches}, unexpected captures "
              f"{unexpected:g}", flush=True)
        assert unexpected == 0, unexpected
        quant_batches = batches["rpc_bf16"] + batches["rpc_int8"]
        assert launches["quantized_affine"] >= quant_batches > 0, launches
        assert launches["fused_cifar_featurize"] >= total_batches, launches

        # agreement, test errors, the quantized parity bars
        f32 = served["rpc_f32"]
        agree = float(np.mean(f32 == preds))
        errors = {name: float(np.mean(p != te_y)) for name, p in
                  served.items()}
        print(f"[serve] f32 served predictions agree with phase 4's batch "
              f"apply on {agree:.4f} of test images; test errors {errors}",
              flush=True)
        assert agree >= 0.999, agree
        graph = {name: {type(op).__name__: op
                        for op in e.fitted.graph.operators.values()}
                 for name, e in entries.items()}
        ops = graph["rpc_f32"]
        F = torch.cat([ops["StandardScalerModel"].apply_batch(
            ops["FusedConvRectifyPool"].apply_batch(torch.as_tensor(
                te_x[i:i + 1024], device=dev)))
            for i in range(0, N_TEST, 1024)])
        scores = {name: graph[name]["BlockLinearMapper"].apply_batch(F)
                  for name in models}
        ref = scores["rpc_f32"]
        for name, wd in models.items():
            if wd is None:
                continue
            min_agree, max_rel = QUANT_BARS[wd]
            flips = scores[name].argmax(1) != ref.argmax(1)
            arg = 1.0 - float(flips.float().mean())
            noise = float((scores[name] - ref).abs().max())
            rel = noise / float(ref.abs().max())
            top2 = ref.topk(2, dim=1).values
            margins = (top2[:, 0] - top2[:, 1])[flips]
            worst_margin = float(margins.max()) if len(margins) else 0.0
            print(f"[serve] {name} scores on the {N_TEST} scaled test "
                  f"features: argmax agreement with f32 {arg:.4f} (bar "
                  f"{min_agree}; {int(flips.sum())} flips, largest f32 "
                  f"top-2 margin among them {worst_margin:.3e} against "
                  f"max |delta| {noise:.3e}), max |delta| / max |f32| "
                  f"{rel:.4e} (bar {max_rel}); test error "
                  f"{errors[name]:.4f} (f32 {errors['rpc_f32']:.4f})",
                  flush=True)
            assert arg >= min_agree and rel <= max_rel, (name, arg, rel)
            assert worst_margin <= 2 * noise, (name, worst_margin, noise)
            assert abs(errors[name] - errors["rpc_f32"]) <= 0.01, errors
        del F, scores, ref

        # eviction and readmission: bit-identical on the same requests
        mapper = graph["rpc_int8"]["BlockLinearMapper"]
        wq = mapper.apply_params(dev)[0].Wt.clone()   # the plan's weights
        again_reqs = requests[:16]
        before = [plane.predict("rpc_int8", r) for r in again_reqs]
        plane.evict("rpc_int8")
        try:
            plane.predict("rpc_int8", again_reqs[0])
            raise AssertionError("an evicted model answered")
        except ModelNotAdmitted:
            pass
        readmitted = plane.readmit("rpc_int8")
        after = [plane.predict("rpc_int8", r) for r in again_reqs]
        wq_again = next(op for op in readmitted.fitted.graph.operators
                        .values() if type(op).__name__ ==
                        "BlockLinearMapper").apply_params(dev)[0].Wt
        assert all(np.array_equal(a, b) for a, b in zip(before, after))
        assert torch.equal(wq, wq_again)
        print(f"[serve] evict + readmit rpc_int8: {len(again_reqs)} requests "
              "bit-identical, Wq bit-identical", flush=True)

        # HTTP: small requests per model, then the error statuses
        rng = np.random.RandomState(SEED + 1)
        t0 = time.perf_counter()
        for name in models:
            i = 0
            for _ in range(HTTP_REQUESTS):
                n = int(rng.randint(1, 5))
                status, out = _post(base, f"/predict/{name}",
                                    {"instances": te_x[i:i + n].tolist()})
                assert status == 200, (status, out)
                assert np.array_equal(np.asarray(out["predictions"]),
                                      served[name][i:i + n]), name
                i += n
        http_s = time.perf_counter() - t0
        statuses = {
            "unknown model": _post(base, "/predict/ghost",
                                   {"instances": te_x[:1].tolist()})[0],
            "bad shape": _post(base, "/predict/rpc_f32", {
                "instances": te_x[:1, :31].tolist()})[0],
        }
        print(f"[serve] HTTP: {HTTP_REQUESTS} requests of 1-4 images per "
              f"model answered 200 and equal to the in-process answers in "
              f"{http_s:.3f} s; statuses {statuses}", flush=True)
        assert statuses == {"unknown model": 404, "bad shape": 400}

        # the serve command, as a subprocess
        lines = _serve_subprocess(model_path, te_x, served["rpc_bf16"])
        print("[serve] subprocess: " + " | ".join(
            s for s in lines if s.startswith(("admitted", "serving ready"))),
            flush=True)
        if "--profile" in sys.argv[1:]:
            _profile("serving burst (rpc_bf16, 4096 images)",
                     lambda: _drive(plane, "rpc_bf16", requests))
    finally:
        server.shutdown()
        plane.close()
    return launches


#: phase 4m, the fleet: replica processes on the one card, each one's
#: budget in model charges (room for all three models: a migration
#: admits before it evicts, and a plane short of room evicts by itself),
#: the models (f32 hot, so it is replicated), the steady window, its
#: offered load, and when in the window the busiest replica is killed
FLEET_REPLICAS, FLEET_BUDGET_CHARGES = 3, 3.5
FLEET_MODELS = {"rpc_f32": None, "rpc_bf16": "bf16", "rpc_int8": "int8"}
FLEET_WINDOW_S, FLEET_RPS, FLEET_KILL_AT = 15.0, 24.0, 0.6
#: request rows at which a bucket's graph is timed against the eager
#: apply (device ms, and host microseconds a request)
FLEET_TIMING_ROWS = (1, 8, 64)
#: how far the pools an admission charges (one probe capture a bucket)
#: may lie above the pools its graphs hold
POOL_CHARGE_MARGIN = 0.02
#: the six single-plane chaos scenarios, each window shortened as the
#: CPU tests shorten it (None: the catalogue's own window)
CHAOS_WINDOWS = {"burst": 0.6, "diurnal": 0.8, "zipf_churn": None,
                 "straggler_dispatch": 0.6, "poisoned_batch": 0.6,
                 "overload_shed": 0.3}


def _short_floats(x):
    """``x`` (float32) as float64 values whose shortest decimal form
    has at most 9 significant digits, each converting back to exactly
    ``x``: JSON requests half as long, carrying the same images."""
    x64 = x.astype(np.float64)
    mag = np.floor(np.log10(np.maximum(np.abs(x64), 1e-30)))
    scale = 10.0 ** (8 - mag)
    out = np.where(x64 == 0, 0.0, np.round(x64 * scale) / scale)
    assert np.array_equal(out.astype(np.float32), x)
    return out


def _get_json(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as rsp:
        return json.loads(rsp.read())


def _metric(port, name):
    """One sample of a replica's ``/metrics`` (0 when absent)."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=120) as rsp:
        for line in rsp.read().decode().splitlines():
            if line.startswith(name + " "):
                return float(line.split()[-1])
    return 0.0


def _start_replicas(n, budget, dev):
    """``n`` replica processes, started together; returns them with their
    ports once each has printed its ``replica on`` line. A thread per
    process keeps draining its output."""
    procs = [subprocess.Popen(
        [sys.executable, "-m", "keystone_tpu_torch.serving.replica",
         "--port", "0", "--device", dev.type, "--hbm-budget",
         str(int(budget)), "--max-batch", str(SERVE_MAX_BATCH),
         "--queue-depth", "256"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for _ in range(n)]
    ports = []
    for proc in procs:
        lines: "queue.Queue" = queue.Queue()

        def read(proc=proc, lines=lines):
            for line in proc.stdout:
                lines.put(line.rstrip())
            lines.put(None)

        threading.Thread(target=read, daemon=True).start()
        seen, deadline = [], time.time() + 180
        while not (seen and seen[-1].startswith("replica on ")):
            line = lines.get(timeout=max(deadline - time.time(), 1.0))
            if line is None:
                raise RuntimeError("a replica exited before it was ready:\n"
                                   + "\n".join(seen))
            seen.append(line)
        ports.append(int(seen[-1].rsplit(":", 1)[1]))
    return procs, ports


def _stop_replicas(procs):
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def _capture_checks(saved, te_x, dev, smi):
    """Phase 4m in process: the score pipelines (featurize, scale, the
    mapper at each weight type) admitted into a CUDA plane; each bucket's
    graph replay against the eager apply of the same padded bucket
    (``torch.equal``), the pools against the charge, and the timing of
    graph against eager at FLEET_TIMING_ROWS."""
    from keystone_tpu_torch.parallel.dataset import bucketed_dataset
    from keystone_tpu_torch.serving import ItemSpec, ServingPlane

    mib = 1 << 20
    ops = {type(op).__name__: op
           for op in saved.to_pipeline().graph.operators.values()}
    scores = ops["FusedConvRectifyPool"].and_then(
        ops["StandardScalerModel"]).and_then(ops["BlockLinearMapper"])
    spec = ItemSpec((32, 32, 3), np.float32)
    plane = ServingPlane(max_batch=SERVE_MAX_BATCH, device=dev).start()
    x = te_x[:SERVE_MAX_BATCH]
    try:
        for name, wd in FLEET_MODELS.items():
            e = plane.admit("scores_" + name.split("_")[1], scores, spec,
                            weight_dtype=wd)
            checked = []
            for n in (SERVE_MAX_BATCH - 14, SERVE_MAX_BATCH, 8, 3):
                graph_out = plane._execute(e, x[:n], n)[0]
                eager_out = plane._eager(e, x[:n], n)
                assert torch.equal(torch.from_numpy(graph_out),
                                   torch.from_numpy(eager_out)), (name, n)
                checked.append(n)
            _pools_within_charge(e.name, e.graph_pool_nbytes,
                                 e.charge.pool_nbytes)
            print(f"[fleet] capture {e.name}: {e.captures} graphs in "
                  f"{e.capture_s:.3f} s, graph pools "
                  f"{e.graph_pool_nbytes / mib:.3f} MiB against the "
                  f"{e.charge.pool_nbytes / mib:.3f} MiB of pools their "
                  f"charge probed (graphs with static inputs "
                  f"{e.charge.graph_nbytes / mib:.3f} MiB, in all "
                  f"{e.charge.total_nbytes() / mib:.3f} MiB); replay "
                  f"torch.equal to the eager apply at n = {checked} | "
                  f"{smi}", flush=True)
            for n in FLEET_TIMING_ROWS:
                bucket = plane.policy.bucket_for(n)
                bg = plane._graphs.get((e.token, bucket))
                ds = bucketed_dataset(x[:n], n, bucket, dev)
                graph_ms = _events_ms(bg.graph.replay, 50)
                eager_ms = _events_ms(lambda: e.fitted.apply(ds).get(), 20)
                graph_us = _host_us(lambda: plane._execute(e, x[:n], n), 50)
                eager_us = _host_us(lambda: plane._eager(e, x[:n], n), 20)
                print(f"[fleet] timing {e.name} n={n} (bucket {bucket}): "
                      f"device {graph_ms:.4f} ms from the graph, "
                      f"{eager_ms:.4f} ms eager; host {graph_us:.1f} us a "
                      f"request on the graph path, {eager_us:.1f} us "
                      f"eager (copy in, apply, copy out) | {smi}",
                      flush=True)
            del bg  # a held graph keeps its pool
        token = plane._models["scores_int8"].token
        pools = [plane._graphs.get(k).graph.pool()
                 for k in plane._graphs.keys() if k[0] == token]
        plane.evict("scores_int8")
        from keystone_tpu_torch.serving.residency import graph_pool_nbytes
        left = sum(graph_pool_nbytes(p, dev) for p in pools)
        del pools
        print(f"[fleet] evicting scores_int8 released its graph pools: "
              f"{left:.0f} bytes left in them", flush=True)
        assert left == 0, left
    finally:
        plane.close()


def _fleet_traffic(kernels, saved, te_x, te_y, preds, dev, smi):
    """Phase 4m's fleet: replicas, router, controller, the replayed
    trace, the kill, the bars through the router. Returns the launches
    the replicas' kernels made in the traffic window: ``replayed`` (the
    served traffic, each graph replay's recorded launches) and ``eager``
    (the wrappers' own: the re-admission's probes and warm applies)."""
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.serving import (
        FleetAutoscaler,
        FleetController,
        FleetRouter,
        HttpReplicaClient,
        ItemSpec,
        serve_router,
    )
    from keystone_tpu_torch.serving.batcher import BucketPolicy
    from keystone_tpu_torch.serving.loadgen import (
        HttpServingClient,
        LoadSpec,
        generate_trace,
        replay,
    )
    from keystone_tpu_torch.serving.plane import graph_rows

    mib = 1 << 20
    reg = MetricsRegistry.get_or_create()
    spec = ItemSpec((32, 32, 3), np.float32)
    n_graphs = len(graph_rows(BucketPolicy(SERVE_MAX_BATCH), dev))
    router = FleetRouter([], spill_queue_depth=8)
    controller = FleetController(router, bucket_rows=SERVE_MAX_BATCH,
                                 device=dev)
    t0 = time.perf_counter()
    for name, wd in FLEET_MODELS.items():
        controller.register(name, saved, spec, weight_dtype=wd,
                            qps=100.0 if wd is None else 0.0, warmup_s=1.0)
    canon = {m: controller._models[m] for m in FLEET_MODELS}
    budget = FLEET_BUDGET_CHARGES * max(m.charge_nbytes
                                        for m in canon.values())
    print(f"[fleet] registered {list(FLEET_MODELS)} in "
          f"{time.perf_counter() - t0:.2f} s: charges "
          f"{ {m: round(c.charge_nbytes / mib, 3) for m, c in canon.items()} }"
          f" MiB, replica budget {budget / mib:.3f} MiB", flush=True)
    _sync()
    free0 = torch.cuda.mem_get_info(dev)[0]
    t0 = time.perf_counter()
    procs, ports = _start_replicas(FLEET_REPLICAS, budget, dev)
    start_s = time.perf_counter() - t0
    free1 = torch.cuda.mem_get_info(dev)[0]
    print(f"[fleet] {FLEET_REPLICAS} replica processes up in {start_s:.2f} "
          f"s; each one's CUDA context (and allocator) holds "
          f"{(free0 - free1) / FLEET_REPLICAS / mib:.1f} MiB of the card "
          f"(free memory before and after) | {smi}", flush=True)
    server = None
    try:
        clients = [HttpReplicaClient(f"r{i}", "127.0.0.1", port,
                                     timeout_s=120.0)
                   for i, port in enumerate(ports)]
        by_id = {c.replica_id: (c, port, proc)
                 for c, port, proc in zip(clients, ports, procs)}
        for c in clients:
            router.add_replica(c)
            controller.set_budget(c.replica_id, budget)
        t0 = time.perf_counter()
        steps = controller.rebalance()
        print(f"[fleet] placement {controller.state()['placement']}: "
              f"{len(steps)} admissions, every sha verified, in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for rid, (c, port, _) in sorted(by_id.items()):
            state = _get_json(port, "/models")
            assert c.model_shas() == {m["name"]: canon[m["name"]].sha256
                                      for m in state["models"]}
            for m in state["models"]:
                print(f"[fleet] {rid} {m['name']}: {m['captures']} "
                      f"captures in {m['capture_s']:.3f} s, graph pools "
                      f"{m['graph_pool_nbytes'] / mib:.3f} MiB against the "
                      f"charge's probed {m['charge_pool_nbytes'] / mib:.3f}"
                      f" MiB (graphs {m['charge_graph_nbytes'] / mib:.3f} "
                      f"MiB) "
                      f"(charge {m['charge_nbytes'] / mib:.3f} MiB, the "
                      f"controller's "
                      f"{canon[m['name']].charge_nbytes / mib:.3f} MiB), "
                      f"warmup {m['warmup_s']:.3f} s", flush=True)
                assert m["captures"] == n_graphs, m
                _pools_within_charge((rid, m["name"]),
                                     m["graph_pool_nbytes"],
                                     m["charge_pool_nbytes"])

        # -- the steady window, with a kill in it ---------------------------
        server = serve_router(router)
        payload = _short_floats(te_x)
        picks = iter(range(10 ** 9))

        def input_for(model, n):
            i = (next(picks) * 97) % (N_TEST - n)
            return payload[i:i + n]

        trace = generate_trace(LoadSpec(
            seed=SEED, duration_s=FLEET_WINDOW_S, rate_rps=FLEET_RPS,
            arrival="poisson", models=tuple(FLEET_MODELS), zipf_s=1.1,
            sizes=tuple(range(1, SERVE_MAX_BATCH + 1))))
        for _, port, _ in by_id.values():
            urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/admin/reset_launches", data=b"{}"),
                timeout=60).read()
        before = {rid: (_metric(port, "keystone_compile_unexpected_total_"
                                "total"),
                        _metric(port, "keystone_serving_rows_total_total"))
                  for rid, (_, port, _) in by_id.items()}
        after, launches = {}, {"replayed": {}, "eager": {}}
        deaths0 = reg.counter("fleet.replica_deaths_total").value
        spill0 = reg.counter("router.spill_total").value
        killed = {}

        def read_replica(rid):
            port = by_id[rid][1]
            after[rid] = (_metric(port, "keystone_compile_unexpected_total_"
                                  "total"),
                          _metric(port, "keystone_serving_rows_total_total"))
            got = _get_json(port, "/admin/launches")
            for part, into in (("replayed", "replayed"),
                               ("kernels", "eager")):
                for k, v in got[part].items():
                    launches[into][k] = launches[into].get(k, 0) + v

        def killer():
            try:
                time.sleep(FLEET_WINDOW_S * FLEET_KILL_AT)
                count = {}
                for reps in controller.placement.assignments.values():
                    for rid in reps:
                        count[rid] = count.get(rid, 0) + 1
                victim = max(sorted(count), key=lambda r: count[r])
                read_replica(victim)
                by_id[victim][2].kill()
                by_id[victim][2].wait(timeout=30)
                t_kill = time.perf_counter()
                killed["action"] = FleetAutoscaler(
                    controller, sustain_ticks=10 ** 6).tick()
                killed.update(victim=victim, models=count[victim],
                              recover_s=time.perf_counter() - t_kill)
            except BaseException as exc:  # noqa: BLE001 - asserted below
                killed["error"] = f"{type(exc).__name__}: {exc}"

        kthread = threading.Thread(target=killer, daemon=True)
        kthread.start()
        report = replay(trace, HttpServingClient(
            "127.0.0.1", server.server_port, request_timeout_s=120.0),
            input_for, senders=CLIENTS, result_timeout_s=120.0)
        kthread.join(timeout=300)
        assert "error" not in killed, killed
        victim = killed["victim"]
        for rid in by_id:
            if rid != victim:
                read_replica(rid)
        unexpected = {rid: after[rid][0] - before[rid][0] for rid in after}
        rows = sum(after[rid][1] - before[rid][1] for rid in after)
        summary = report.summary()
        deaths = reg.counter("fleet.replica_deaths_total").value - deaths0
        spill = reg.counter("router.spill_total").value - spill0
        lat = [_metric(by_id[rid][1], f'keystone_serving_request_ms'
                       f'{{quantile="{q}"}}') for rid in by_id
               if rid != victim for q in ("0.5", "0.99")]
        print(f"[fleet] steady window {FLEET_WINDOW_S:g} s, "
              f"{len(trace.arrivals)} requests (Poisson {FLEET_RPS:g}/s, "
              f"Zipf over {list(FLEET_MODELS)}, 1-{SERVE_MAX_BATCH} rows, "
              f"{CLIENTS} closed-loop clients over HTTP to the router): "
              f"{rows:.0f} rows served in {report.wall_s:.2f} s "
              f"({rows / report.wall_s:.1f} rows/s); client request_ms "
              f"p50 {report.p50_ms():.3f} p99 {report.p99_ms():.3f}; the "
              f"survivors' serving.request_ms (p50, p99) {lat}; "
              f"availability {report.availability():.4f}; outcomes "
              f"{summary['outcomes']}; router.spill_total {spill:g}; "
              f"compile.unexpected_total delta per replica {unexpected} "
              f"| {smi}", flush=True)
        print(f"[fleet] death: {victim} (hosting {killed['models']} models)"
              f" killed at {FLEET_KILL_AT:.0%} of the window; the reactor "
              f"classified it as {killed['action']!r}, "
              f"fleet.replica_deaths_total {deaths:g}, recovery (re-solve, "
              f"re-admission, sha verified) {killed['recover_s']:.2f} s; "
              f"placement now {controller.state()['placement']}",
              flush=True)
        assert killed["action"] == "death" and deaths == 1, (killed, deaths)
        assert victim not in router.replica_ids()
        assert all(router.state()["models"].get(m) for m in FLEET_MODELS), \
            router.state()
        for rid in router.replica_ids():
            c = by_id[rid][0]
            for m, sha in c.model_shas().items():
                assert sha == canon[m].sha256, (rid, m)
        assert summary["outcomes"]["unclassified"] == 0, summary
        assert all(v == 0 for v in unexpected.values()), unexpected
        print(f"[fleet] launches in the window: served traffic (graph "
              f"replays x the launches each capture recorded) "
              f"{launches['replayed']}; the re-admission's eager launches "
              f"(its probes and warm applies; a capture only records) "
              f"{launches['eager']}", flush=True)
        if dev.type == "cuda":  # a CPU rehearsal runs the plain versions
            served_launches = launches["replayed"]
            assert served_launches.get("fused_cifar_featurize", 0) > 0, \
                launches
            assert served_launches.get("quantized_affine", 0) > 0, launches

        # -- the test set through the router: phase 4c's bars --------------
        served = {}
        base = f"http://127.0.0.1:{server.server_port}"
        t0 = time.perf_counter()
        for name in FLEET_MODELS:
            starts = list(range(0, N_TEST, SERVE_MAX_BATCH))
            with ThreadPoolExecutor(CLIENTS) as pool:
                outs = list(pool.map(lambda i: _post(
                    base, f"/predict/{name}",
                    {"instances": payload[i:i + SERVE_MAX_BATCH].tolist()}),
                    starts))
            assert all(status == 200 for status, _ in outs), outs[:1]
            served[name] = np.concatenate(
                [np.asarray(out["predictions"]) for _, out in outs])
        agree = float(np.mean(served["rpc_f32"] == preds))
        line = (f"[fleet] the {N_TEST} test images through the router in "
                f"{time.perf_counter() - t0:.2f} s: f32 agreement with "
                f"phase 4's batch apply {agree:.4f}")
        assert agree >= 0.999, agree
        for name, wd in FLEET_MODELS.items():
            if wd is None:
                continue
            arg = float(np.mean(served[name] == served["rpc_f32"]))
            line += f", {name} argmax agreement with f32 {arg:.4f}"
            assert arg >= QUANT_BARS[wd][0], (name, arg)
        errors = {n: round(float(np.mean(p != te_y)), 4)
                  for n, p in served.items()}
        print(f"{line}; test errors {errors}", flush=True)
    finally:
        if server is not None:
            server.shutdown()
        _stop_replicas(procs)
    return launches


def _chaos_phase(dev, smi):
    """Phase 4m's six single-plane chaos scenarios on a CUDA plane."""
    from keystone_tpu_torch.serving.scenarios import (load_catalogue,
                                                      run_scenario)

    load_catalogue()
    for name, window in CHAOS_WINDOWS.items():
        res = run_scenario(name, seed=0, duration_s=window, device=dev)
        out = res.report.outcomes
        print(f"[chaos] {name} (seed 0, window "
              f"{window if window is not None else 'catalogue'}): p99 "
              f"{res.p99_ms:.2f} ms (floor {res.floors.p99_ms:g}), "
              f"availability {res.availability:.4f} (floor "
              f"{res.floors.availability:g}), injections {res.injections},"
              f" outcomes {out}, wall {res.wall_s:.2f} s | {smi}",
              flush=True)
        assert out["unclassified"] == 0 and res.clean, (name,
                                                         res.violations)


def _fleet_phase(kernels, model_path, te_x, te_y, preds, dev, smi):
    """Phase 4m (see the module docstring). Returns the launches of the
    fleet's traffic window."""
    from keystone_tpu_torch.utils.checkpoint import load_pipeline

    saved = load_pipeline(model_path, device=dev)
    _capture_checks(saved, te_x, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    launches = _fleet_traffic(kernels, saved, te_x, te_y, preds, dev, smi)
    gc.collect()
    torch.cuda.empty_cache()
    _chaos_phase(dev, smi)
    return launches


def _sift_contractions(sift, H, W, scale):
    """The two band contractions of one SIFT scale on an (H, W) image at
    the VOCSIFTFisher defaults, as (name, left band, right band,
    channels)."""
    step, b, lo = sift._scale_params(scale, 4, 6, 5, 0)
    Ty, _ = sift._sampling_operator_interleaved(H, lo, step, b)
    Tx, _ = sift._sampling_operator_interleaved(W, lo, step, b)
    return [("smooth", sift._smooth_band(H, b), sift._smooth_band(W, b), 1),
            ("bin + sample", Ty, Tx, 8)]


def _check_banded(kernels, sift, rng, dev):
    """The two-sided banded_matmul against its plain version on scale 0's
    and scale 4's two contractions at both VOC orientations, and the
    one-sided product (the TPU kernel's own function) on scale 0's
    smoothing band and a seeded random band; prints each band's nonzeros
    a row and 32-row live ranges, and checks that a second launch gives
    the same bits. Returns the largest absolute error."""
    cases = [(f"{H}x{W} scale {sc} {name}", left, right,
              torch.as_tensor(rng.rand(C, H, W).astype(np.float32),
                              device=dev))
             for H, W in ((375, 500), (500, 375)) for sc in (0, 4)
             for name, left, right, C in _sift_contractions(sift, H, W, sc)]
    rand = np.zeros((500, 520), np.float32)
    for j in range(500):
        c = min(int(j * 1.04), 519)
        rand[j, max(0, c - 13):c + 14] = rng.randn(
            min(520, c + 14) - max(0, c - 13))
    for label, band, rows, cols in (
            ("one-sided seeded random band", rand, 520, 777),
            ("one-sided 375x500 scale 0 smooth", sift._smooth_band(375, 6),
             375, 500)):
        cases.append((label, band, None, torch.as_tensor(
            rng.rand(rows, cols).astype(np.float32), device=dev)))
    worst = 0.0
    for label, left, right, X in cases:
        got = kernels.banded_matmul(left, X, right=right)
        want = kernels.banded_matmul_plain(left, X, right=right)
        again = kernels.banded_matmul(left, X, right=right)
        _sync()
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, again), label
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ranges = []
        for band in (left, right):
            if band is not None:
                klo, khi = kernels.band_live_map(band, kernels.band_tile_rows())
                nnz = (band != 0).sum(axis=1)
                ranges.append(f"{band.shape}: nonzeros a row {nnz.min()}-"
                              f"{nnz.max()}, 32-row live ranges "
                              f"{int((khi - klo).min())}-"
                              f"{int((khi - klo).max())}")
        print(f"[check] banded_matmul {label} X {tuple(X.shape)}: max abs err "
              f"{err:.3e} (max |plain| {scale:.3e}, rel {err / scale:.3e}); "
              f"{'; '.join(ranges)}", flush=True)
        assert err <= BANDED_TOL * scale, (label, err, scale)
        worst = max(worst, err)
    return worst


def _fv_inputs(rng, D, K, n, dev):
    X = rng.randn(D, n).astype(np.float32)
    means = rng.randn(D, K).astype(np.float32)
    variances = (0.5 + rng.rand(D, K)).astype(np.float32)
    weights = rng.dirichlet(np.ones(K)).astype(np.float32)
    return [torch.as_tensor(a, device=dev)
            for a in (X, means, variances, weights)]


#: fv_moments at GMMs past the resident tiles (D, K, n, seed): the llh
#: tile of K = 30000 and 4000 components, the x' tiles of D = 512 rows.
#: Seeds whose posteriors all lie at least 2.8e-4 (in log) from the 1e-4
#: threshold in float64, so float32 rounding cannot flip one across it
FV_WIDE = ((2, 30000, 1, 30), (8, 4000, 17, 1), (512, 256, 513, 768))


def _check_fv(kernels, rng, dev):
    """fv_moments against its plain version at the full-width FV shape and
    at ragged descriptor counts, at K = 256 and 257 (off the 256
    components a block accumulates), the GMM terms precomputed as the
    path does, and at the GMMs of FV_WIDE; a second launch must give the
    same bits. Returns the largest absolute error."""
    cases = [(80, K, n, None) for K in (256, 257)
             for n in (47213, 1, 511, 513, 4097)] + list(FV_WIDE)
    worst = 0.0
    for D, K, n, seed in cases:
        X, means, variances, weights = _fv_inputs(
            rng if seed is None else np.random.RandomState(seed), D, K, n,
            dev)
        terms = kernels.fv_terms(means, variances, weights)
        got = kernels.fv_moments(X, means, variances, weights, 1e-4,
                                 terms=terms)
        again = kernels.fv_moments(X, means, variances, weights, 1e-4,
                                   terms=terms)
        want = kernels.fv_moments_plain(X, means, variances, weights, 1e-4)
        _sync()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        errs = []
        for name, g, w in zip(("s0", "s1", "s2"), got, want):
            assert bool(torch.isfinite(g).all())
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            errs.append(f"{name} {err:.3e} (rel {err / scale:.3e})")
            assert err <= FV_TOL * scale, (D, K, n, name, err, scale)
            worst = max(worst, err)
        print(f"[check] fv_moments D={D} K={K} n={n}: max abs err "
              f"{', '.join(errs)}", flush=True)
    return worst


class _RuleClock:
    """What the node-level rule does per optimizable node: whether the
    choice came from the analyzer's shapes (``optimize_static``) or from a
    sampled execution, the seconds of the sampled execution (the card
    synchronized after it) and of the node's hook, the kernel launches the
    sampled execution makes, and the choice; also every
    ``LeastSquaresEstimator._choose`` call
    (the rule's and a streamed finalize's) with its arguments, so the
    density and each candidate's cost can be printed; and, per
    application of the rule that splices, its seconds, the device memory
    its values on the sample hold after its last splice, and the memory
    it leaves allocated when it returns. ``close`` removes the
    wrappers."""

    def __init__(self, kernels):
        from keystone_tpu_torch.nodes.images.fisher_vector import (
            GMMFisherVectorEstimator,
        )
        from keystone_tpu_torch.nodes.learning.least_squares import (
            LeastSquaresEstimator,
        )
        from keystone_tpu_torch.nodes.learning.pca import ColumnPCAEstimator
        from keystone_tpu_torch.workflow.optimizer.node_rule import (
            NodeOptimizationRule,
            _SampledValues,
        )

        self.nodes, self.choices, self.applies, self._undo = [], [], [], []
        self._sample = None
        self._static_depth = 0
        self._values_held = 0
        clock = self

        def apply(real):
            def run(rule, graph):
                _sync()
                base = torch.cuda.memory_allocated()
                clock._values_held = 0
                t0 = time.perf_counter()
                out = real(rule, graph)
                _sync()
                if rule.splices:
                    clock.applies.append({
                        "seconds": time.perf_counter() - t0,
                        "values": clock._values_held - base,
                        "held": torch.cuda.memory_allocated() - base})
                return out
            return run

        def drop(real):
            def run(values, graph, node):
                clock._values_held = torch.cuda.memory_allocated()
                return real(values, graph, node)
            return run

        def sampled(real):
            def run(graph, deps, values):
                before = dict(kernels.LAUNCHES)
                t0 = time.perf_counter()
                out = real(graph, deps, values)
                _sync()
                clock._sample = (time.perf_counter() - t0, {
                    k: v - before.get(k, 0)
                    for k, v in kernels.LAUNCHES.items()
                    if v != before.get(k, 0)})
                return out
            return run

        def record(node, choice, t0, provenance):
            seconds, launches = clock._sample or (0.0, {})
            clock._sample = None
            clock.nodes.append({
                "node": type(node).__name__,
                "chosen": type(choice.node).__name__,
                "prefix": [type(t).__name__ for t in choice.prefix],
                "provenance": provenance,
                "sample_s": seconds,
                "optimize_s": time.perf_counter() - t0,
                "sample_launches": launches})

        def optimize(real):
            def run(node, *args, **kw):
                t0 = time.perf_counter()
                # a sampled execution ran for this node, or the static
                # hook called ``optimize`` itself (the GMM's choice
                # depends on k alone)
                provenance = "sampled" if clock._sample else "static"
                choice = real(node, *args, **kw)
                if not clock._static_depth:
                    record(node, choice, t0, provenance)
                return choice
            return run

        def optimize_static(real):
            def run(node, *args, **kw):
                t0 = time.perf_counter()
                clock._static_depth += 1
                try:
                    choice = real(node, *args, **kw)
                finally:
                    clock._static_depth -= 1
                if choice is not None:
                    record(node, choice, t0, "static")
                return choice
            return run

        def choose(real):
            def run(est, n, d, k, sparsity, machines, streaming=False,
                    **kw):
                choice = real(est, n, d, k, sparsity, machines, streaming,
                              **kw)
                clock.choices.append({
                    "args": (n, d, k, sparsity, machines),
                    "streaming": streaming,
                    "shape_source": kw.get("shape_source"),
                    "costs": {type(solver).__name__: cost for cost, solver, _
                              in est.costs(n, d, k, sparsity, machines,
                                           streaming)},
                    "choice": choice})
                return choice
            return run

        self._wrap(NodeOptimizationRule, "apply", apply)
        self._wrap(_SampledValues, "drop", drop)
        self._wrap(NodeOptimizationRule, "_execute_sampled",
                   lambda real: staticmethod(sampled(real)))
        for cls in (LeastSquaresEstimator, ColumnPCAEstimator,
                    GMMFisherVectorEstimator):
            self._wrap(cls, "optimize", optimize)
            self._wrap(cls, "optimize_static", optimize_static)
        self._wrap(LeastSquaresEstimator, "_choose", choose)

    def _wrap(self, owner, attr, make):
        # restored as found in the class (a staticmethod stays one)
        self._undo.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, make(getattr(owner, attr)))

    def close(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo = []

    def summary(self):
        return "; ".join(
            [f"{n['node']} -> {' -> '.join(n['prefix'] + [n['chosen']])} "
             f"({n['provenance']}): sampled execution {n['sample_s']:.3f} s "
             f"(launches {n['sample_launches']}), optimize "
             f"{n['optimize_s']:.4f} s" for n in self.nodes]
            + [f"rule applied in {a['seconds']:.3f} s; its values on the "
               f"sample held {a['values'] / 2**20:+.1f} MiB at its last "
               f"splice, {a['held'] / 2**20:+.1f} MiB left allocated when "
               f"it returned" for a in self.applies])


class _OptimizerClock:
    """Host seconds of the optimizer's executions (one per graph a fit or
    an apply optimizes), of its CSE passes and of its fusion rule
    applications (map and gather, each a scan of the graph), counted by
    wrapping ``Optimizer.execute``, ``EquivalentNodeMergeRule.apply`` and
    the two fusion rules' ``apply``; the card is not synchronized, as all
    are host code. The first execution's input and output graphs are
    kept in ``first``. ``close`` removes the wrappers.

    A traced run's rule log (``PipelineTrace.optimizer_rules``) counts
    other things: only the applications that rewrote the graph, and
    only outside ``tracing_disabled``. The clock counts every
    application and every execution, rewriting or not, traced or not;
    its executions equal the trace's ``meta["optimizer_runs"]`` when no
    execution ran inside ``tracing_disabled`` (phase 4t(c))."""

    def __init__(self):
        from keystone_tpu_torch.workflow.optimizer.fusion import (
            GatherFusionRule,
            MapFusionRule,
        )
        from keystone_tpu_torch.workflow.optimizer.rule import Optimizer
        from keystone_tpu_torch.workflow.optimizer.rules import (
            EquivalentNodeMergeRule,
        )

        names = ("execute", "CSE pass", "fusion rule")
        self.counts = dict.fromkeys(names, 0)
        self.seconds = dict.fromkeys(names, 0.0)
        self.first = None
        self._undo = []
        self._wrap(Optimizer, "execute", "execute")
        self._wrap(EquivalentNodeMergeRule, "apply", "CSE pass")
        self._wrap(MapFusionRule, "apply", "fusion rule")
        self._wrap(GatherFusionRule, "apply", "fusion rule")

    def _wrap(self, owner, attr, name):
        real = getattr(owner, attr)

        def run(*args):
            t0 = time.perf_counter()
            out = None
            try:
                out = real(*args)
                return out
            finally:
                self.counts[name] += 1
                self.seconds[name] += time.perf_counter() - t0
                if name == "execute" and self.first is None:
                    self.first = (args[-1], out)

        setattr(owner, attr, run)
        self._undo.append((owner, attr, real))

    def close(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)
        self._undo = []

    def summary(self):
        c, s = self.counts, self.seconds
        return (f"optimizer {c['execute']} executions, "
                f"{s['execute']:.4f} s; CSE {c['CSE pass']} passes, "
                f"{s['CSE pass']:.4f} s; fusion {c['fusion rule']} rule "
                f"applications, {s['fusion rule']:.4f} s (host)")


def _fit_path_ops(graph):
    """The operators a fit of ``graph`` executes: those not downstream of
    its runtime source."""
    unexec = graph.source_descendants()
    return [graph.get_operator(n) for n in sorted(graph.nodes,
                                                  key=lambda g: g.id)
            if n not in unexec]


def _fused_featurizers(ops, branches):
    """The fused nodes among ``ops`` that hold a gather of ``branches``
    branches feeding a VectorCombiner."""
    from keystone_tpu_torch.workflow.optimizer.fusion import (
        FusedGatherTransformer,
        FusedTransformer,
    )

    return [op for op in ops if isinstance(op, FusedTransformer)
            and isinstance(op.stages[0], FusedGatherTransformer)
            and len(op.stages[0].branches) == branches
            and type(op.stages[-1]).__name__ == "VectorCombiner"]


class _StageTimer:
    """Calls per pipeline stage, by wrapping the stage's method; with
    ``timed``, also seconds, the card synchronized on both sides of every
    call. Those synchronizations remove the overlap of host and device
    work that the path relies on, so a timed pass's totals are not the
    path's own. A call on meta tensors (the node rule's analyzer running
    the stage for its output shape) is not a stage call and is not
    counted. ``close`` removes the wrappers."""

    def __init__(self, timed):
        self.timed = timed
        self.seconds, self.calls, self._undo = {}, {}, []

    def wrap(self, owner, attr, stage):
        real = getattr(owner, attr)
        self.seconds.setdefault(stage, 0.0)
        self.calls.setdefault(stage, 0)

        def wrapped(*args, **kwargs):
            if any(isinstance(a, torch.Tensor) and a.device.type == "meta"
                   for a in args):
                return real(*args, **kwargs)
            self.calls[stage] += 1
            if not self.timed:
                return real(*args, **kwargs)
            _sync()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            _sync()
            self.seconds[stage] += time.perf_counter() - t0
            return out

        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, real))

    def close(self):
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)


def _voc_kernel_check(kernels, sift, fitted, images, dev):
    """VOC_CHECK test images through SIFT -> PCA -> FV with the kernels and
    again with the plain versions (the einsum SIFT and the posterior-form
    moments), both on the card. Descriptors are held to the golden
    envelope (max <= 2, mean <= 0.15 quantized units) over the columns
    that neither path zeroes at the contrast threshold alone (a float32
    flip there moves a whole column; those flips are counted and must stay
    below 1e-4 of the columns). On the kernel path's PCA'd descriptors the
    moment sums are held kernel against plain at FV_TOL, and each path's
    Fisher vector against the same Fisher vector computed in float64
    (the moment form cancels: see FV64_TOL). The kernel path runs with
    the GMM terms the fitted node cached. Returns a summary dict."""
    from keystone_tpu_torch.nodes.images.core import GrayScaler, PixelScaler
    from keystone_tpu_torch.nodes.images.fisher_vector import _fisher_vector

    pca = _operator(fitted, "BatchPCATransformer").apply_params(dev)
    fv = _operator(fitted, "FisherVector")
    params = fv.apply_params(dev)       # means, variances, weights, terms
    gmm, terms = params[:3], params[3]
    params64 = [p.double() for p in gmm]
    thr = fv.weight_threshold
    out = {"max": 0.0, "mean": 0.0, "flips": 0, "cols": 0, "moments": 0.0,
           "kernel64": 0.0, "plain64": 0.0, "paths": 0.0}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for img in images:
        gray = GrayScaler().apply(PixelScaler().apply(img.to(dev)))[..., 0]
        a = sift.dense_sift(gray)
        b = sift.dense_sift_plain(gray)
        za, zb = (a.sum(0) == 0), (b.sum(0) == 0)
        diff = (a - b).abs()[:, ~(za ^ zb)]
        out["max"] = max(out["max"], float(diff.max()))
        out["mean"] = max(out["mean"], float(diff.mean()))
        out["flips"] += int((za ^ zb).sum())
        out["cols"] += a.shape[1]
        X = pca.T @ a
        for g, w in zip(kernels.fv_moments(X, *gmm, thr, terms=terms),
                        kernels.fv_moments_plain(X, *gmm, thr)):
            out["moments"] = max(out["moments"], rel(g, w))
        f64 = _fisher_vector(X.double(), *params64, thr,
                             moments=kernels.fv_moments_plain)
        fk = _fisher_vector(X, *gmm, thr, moments=functools.partial(
            kernels.fv_moments, terms=terms))
        fp = _fisher_vector(X, *gmm, thr, moments=kernels.fv_moments_plain)
        fb = _fisher_vector(pca.T @ b, *gmm, thr,
                            moments=kernels.fv_moments_plain)
        out["kernel64"] = max(out["kernel64"], rel(fk, f64))
        out["plain64"] = max(out["plain64"], rel(fp, f64))
        out["paths"] = max(out["paths"], rel(fk, fb))
    _sync()
    return out


def _voc_stage_timer(timed):
    """A _StageTimer on phase 4d's stages: SIFT, PCA fit, k-means++ + EM
    (and each EM iteration), FV, BCD."""
    from keystone_tpu_torch.nodes.images.extractors import SIFTExtractor
    from keystone_tpu_torch.nodes.images.fisher_vector import FisherVector
    from keystone_tpu_torch.nodes.learning import gmm as gmm_mod
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.pca import (
        DistributedColumnPCAEstimator,
    )

    timer = _StageTimer(timed)
    timer.wrap(SIFTExtractor, "apply", "SIFT")
    timer.wrap(DistributedColumnPCAEstimator, "_fit", "PCA fit")
    timer.wrap(gmm_mod.GaussianMixtureModelEstimator, "fit_matrix",
               "k-means++ + EM")
    timer.wrap(gmm_mod, "_em_iter", "EM iteration")
    timer.wrap(FisherVector, "apply", "FV")
    timer.wrap(BlockLeastSquaresEstimator, "_fit", "BCD")
    return timer


def _voc_fit_apply(voc, config, train, test, dev, timer):
    """One VOCSIFTFisher fit on ``train`` and apply on ``test`` from a
    clean prefix memo, with ``timer``'s wrappers in place. Returns the
    fitted pipeline, the test scores, the fit and apply seconds and the
    stage calls of the fit."""
    from keystone_tpu_torch.loaders.voc import NUM_CLASSES
    from keystone_tpu_torch.nodes.images.multilabel import (
        MultiLabeledImageExtractor,
        MultiLabelExtractor,
    )
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntArrayLabels,
    )
    from keystone_tpu_torch.workflow.common import Cacher
    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.reset()
    try:
        _sync()
        t0 = time.time()
        labels = (MultiLabelExtractor(dev)
                  >> ClassLabelIndicatorsFromIntArrayLabels(NUM_CLASSES)
                  >> Cacher())(train).get()
        train_data = MultiLabeledImageExtractor(dev).apply_dataset(train)
        fitted = voc.build_pipeline(config, train_data, labels).fit()
        _sync()
        fit_s = time.time() - t0
        fit_calls = dict(timer.calls)
        t0 = time.time()
        test_data = MultiLabeledImageExtractor(dev).apply_dataset(test)
        scores = torch.stack(fitted(test_data).get().collect())
        _sync()
        apply_s = time.time() - t0
    finally:
        timer.close()
    return fitted, scores, fit_s, apply_s, fit_calls


def _release():
    """A clean prefix memo and environment, and the card's cached blocks
    returned."""
    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()


def _voc_phase(kernels, dev):
    """Phase 4d (see the module docstring). Returns the kernel launch
    counts of the main pass's fit + apply, and the surrogate, its MAP,
    the random scores' MAP and the fit and apply seconds for 4n(a)."""
    from keystone_tpu_torch.evaluation.mean_average_precision import (
        evaluate_mean_average_precision,
    )
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_voc
    from keystone_tpu_torch.loaders.voc import NUM_CLASSES
    from keystone_tpu_torch.nodes.images.multilabel import (
        MultiLabeledImageExtractor,
    )
    from keystone_tpu_torch.ops import sift
    from keystone_tpu_torch.parallel.dataset import HostDataset
    from keystone_tpu_torch.pipelines.images.voc import voc_sift_fisher as voc

    t0 = time.time()
    train, test = make_surrogate_voc(VOC_TRAIN, VOC_TEST, seed=SEED)
    print(f"[voc] surrogate VOC: {VOC_TRAIN} train / {VOC_TEST} test images "
          f"at 375x500 and 500x375 made in {time.time() - t0:.1f} s",
          flush=True)
    config = voc.SIFTFisherConfig()

    # the main pass: stage calls counted, nothing synchronized or timed
    # inside the fit and the apply
    counter = _voc_stage_timer(timed=False)
    rule = _RuleClock(kernels)
    _sync()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        fitted, scores, fit_s, apply_s, fit_calls = _voc_fit_apply(
            voc, config, train, test, dev, counter)
    finally:
        rule.close()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    sift_apps = counter.calls["SIFT"]
    fv_apps = counter.calls["FV"]
    actuals = [it.labels for it in test.collect()]
    ap = evaluate_mean_average_precision(actuals, scores, NUM_CLASSES)
    vmap = float(np.mean(ap))
    rand = np.random.RandomState(SEED).randn(VOC_TEST, NUM_CLASSES)
    rand_map = float(np.mean(evaluate_mean_average_precision(
        actuals, rand, NUM_CLASSES)))
    g = _operator(fitted, "FisherVector").gmm
    print(f"[voc] VOCSIFTFisher desc_dim {config.desc_dim}, vocab "
          f"{config.vocab_size}, {2 * config.desc_dim * config.vocab_size} "
          f"FV features, block {config.block_size}, no stage timers: fit "
          f"{fit_s:.2f} s ({VOC_TRAIN / fit_s:.1f} train img/s), apply "
          f"{apply_s:.2f} s ({VOC_TEST / apply_s:.1f} test img/s), "
          f"{(VOC_TRAIN + VOC_TEST) / (fit_s + apply_s):.1f} img/s overall",
          flush=True)
    print(f"[voc] node-level rule (seconds inside the fit): "
          f"{rule.summary()}", flush=True)
    assert [(n["node"], n["chosen"], n["provenance"]) for n in rule.nodes] \
        == [("ColumnPCAEstimator", "DistributedColumnPCAEstimator",
             "static"),
            ("GMMFisherVectorEstimator", "EncEvalGMMFisherVectorEstimator",
             "static")], rule.nodes
    print(f"[voc] EM iterations {counter.calls['EM iteration']}; SIFT "
          f"applications {sift_apps} ({fit_calls['SIFT']} in the fit), FV "
          f"applications {fv_apps}", flush=True)
    print(f"[voc] test MAP {vmap:.4f} (seeded random scores {rand_map:.4f});"
          f" APs {np.round(ap, 4).tolist()}; GMM weights sum "
          f"{float(g.weights.sum()):.6f}, min variance "
          f"{float(g.variances.min()):.4e}; device-memory peak "
          f"{peak / 2**30:.2f} GiB; launches {launches}", flush=True)
    assert scores.shape == (VOC_TEST, NUM_CLASSES)
    assert bool(torch.isfinite(scores).all())
    # the analyzer resolves both choices (as the JAX package's default
    # does on the same graph, tests/test_torch_static_analysis.py): SIFT
    # runs on no sample
    assert sift_apps == VOC_TRAIN + VOC_TEST, sift_apps
    RULE_RECORDS["4d"] = (rule.nodes, launches, VOC_TRAIN + VOC_TEST)
    assert launches["banded_matmul"] == 10 * sift_apps, (launches, sift_apps)
    assert launches["banded_matmul"] >= 10 * (VOC_TRAIN + VOC_TEST)
    assert launches["fv_moments"] == fv_apps >= VOC_TRAIN + VOC_TEST, \
        (launches, fv_apps)
    assert abs(float(g.weights.sum()) - 1.0) <= 1e-3
    assert bool((g.variances > 0).all())
    assert np.isfinite(vmap) and vmap > rand_map + VOC_MAP_MARGIN, (
        vmap, rand_map)
    assert abs(vmap - VOC_MAP_FIRST) <= VOC_MAP_DRIFT, vmap

    check = _voc_kernel_check(kernels, sift, fitted,
                              [torch.as_tensor(it.image) for it in
                               test.collect()[:VOC_CHECK]], dev)
    print(f"[voc] {VOC_CHECK} test images, kernels against plain versions "
          f"on the card: descriptors max |delta| {check['max']:.3e}, mean "
          f"{check['mean']:.3e} (quantized units), contrast-threshold flips "
          f"{check['flips']} of {check['cols']} columns; FV moment sums "
          f"max |delta| / max {check['moments']:.3e}; Fisher vectors "
          f"against float64, max |delta| / max: kernel "
          f"{check['kernel64']:.3e}, plain {check['plain64']:.3e}; kernel "
          f"path against plain path {check['paths']:.3e}", flush=True)
    assert check["max"] <= 2.0 and check["mean"] <= 0.15, check
    assert check["flips"] <= 1e-4 * check["cols"], check
    assert check["moments"] <= FV_TOL, check
    assert check["kernel64"] <= FV64_TOL, check
    assert check["kernel64"] <= 2 * check["plain64"], check
    if "--profile" in sys.argv[1:]:
        sub = MultiLabeledImageExtractor(dev).apply_dataset(
            HostDataset(test.collect()[:VOC_PROFILE]))
        _profile(f"VOC test apply ({VOC_PROFILE} images)",
                 lambda: fitted(sub).get())
    del fitted, scores
    _release()

    # a second, instrumented pass for the per-stage split
    timer = _voc_stage_timer(timed=True)
    fitted, _, t_fit_s, t_apply_s, _ = _voc_fit_apply(
        voc, config, train, test, dev, timer)
    stages = ", ".join(f"{k} {v:.3f} s ({timer.calls[k]} calls)"
                       for k, v in timer.seconds.items())
    print(f"[voc] instrumented pass (the card synchronized around every "
          f"stage call): fit {t_fit_s:.2f} s, apply {t_apply_s:.2f} s; "
          f"seconds per stage: {stages}", flush=True)
    del fitted
    _release()
    return launches, (train, test, vmap, rand_map, fit_s, apply_s)


def _image_bytes(img, fmt="JPEG"):
    """One uint8 (H, W, 3) image as JPEG bytes at JPEG_QUALITY, or as
    PNG bytes (lossless)."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **(
        {"quality": JPEG_QUALITY} if fmt == "JPEG" else {"compress_level": 1}))
    return buf.getvalue()


def _add_member(tf, name, data):
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def _write_tars(directory, members, n_tars):
    """``members`` (name, uint8 image) encoded as JPEG on a thread pool
    and written in order into ``n_tars`` tars under ``directory``.
    Returns the JPEG bytes of each member, in order."""
    os.makedirs(directory, exist_ok=True)
    with ThreadPoolExecutor(8) as pool:
        data = list(pool.map(lambda m: _image_bytes(m[1]), members))
    per = -(-len(members) // n_tars)
    for t in range(n_tars):
        with tarfile.open(os.path.join(directory, f"part{t:02d}.tar"),
                          "w") as tf:
            for i in range(t * per, min(len(members), (t + 1) * per)):
                _add_member(tf, members[i][0], data[i])
    return data


def _run_cli(argv, timer):
    """``python -m keystone_tpu_torch`` in process: its exit code, its
    standard output (echoed, indented) and its wall seconds, the card
    synchronized at the end; ``timer``'s wrappers in place during it."""
    from keystone_tpu_torch import __main__ as cli

    out = io.StringIO()
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        _sync()
    finally:
        timer.close()
    wall = time.time() - t0
    text = out.getvalue()
    for line in text.splitlines():
        print(f"    | {line}", flush=True)
    return rc, text, wall


def _printed_number(text, prefix):
    line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
    return float(line[len(prefix):].strip().rstrip("%"))


def _voc_tar_phase(kernels, ref, launches_4d, workdir, dev):
    """Phase 4n(a) (see the module docstring). Returns the kernel launch
    counts of the run."""
    from PIL import Image

    from keystone_tpu_torch.loaders import VOCDataPath, VOCLabelPath
    from keystone_tpu_torch.pipelines.images.voc import voc_sift_fisher as voc
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    train, test, vmap_4d, rand_map, fit_4d, apply_4d = ref
    root = os.path.join(workdir, "voc")
    rows = ["name,cls,x,y,file"]
    t0 = time.time()
    for split, ds, n_tars in (("train", train, VOC_TARS[0]),
                              ("test", test, VOC_TARS[1])):
        members = []
        for i, it in enumerate(ds.collect()):
            name = f"{split}{i:05d}.jpg"
            members.append((voc.IMAGES_PREFIX + name,
                            np.rint(it.image).astype(np.uint8)))
            rows += [f'x,{c + 1},a,b,"{name}"' for c in it.labels]
        jpegs = _write_tars(os.path.join(root, split), members, n_tars)
    labels = os.path.join(root, "labels.csv")
    with open(labels, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"[voc-tar] {VOC_TRAIN} / {VOC_TEST} phase 4d images as JPEG "
          f"(quality {JPEG_QUALITY}) in {VOC_TARS[0]} / {VOC_TARS[1]} tars "
          f"under {voc.IMAGES_PREFIX}, labels CSV: written in "
          f"{time.time() - t0:.1f} s", flush=True)

    _release()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    timer = _StageTimer(timed=True)
    timer.wrap(voc, "voc_loader", "load")
    timer.wrap(Pipeline, "fit", "fit")
    rc, text, wall = _run_cli(
        ["voc.sift_fisher", "--trainLocation", os.path.join(root, "train"),
         "--testLocation", os.path.join(root, "test"), "--labelPath", labels],
        timer)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    vmap = _printed_number(text, "TEST MAP is:")
    load_s, fit_s = timer.seconds["load"], timer.seconds["fit"]
    print(f"[voc-tar] python -m keystone_tpu_torch voc.sift_fisher at the "
          f"published defaults, {VOC_TRAIN} / {VOC_TEST} images from tars: "
          f"exit {rc}, {wall:.2f} s in all: load {load_s:.2f} s (both "
          f"splits, {(VOC_TRAIN + VOC_TEST) / load_s:.0f} img/s), fit "
          f"{fit_s:.2f} s, apply and evaluation {wall - load_s - fit_s:.2f}"
          f" s (phase 4d, from memory: fit {fit_4d:.2f} s, apply "
          f"{apply_4d:.2f} s); test MAP {vmap:.4f} (phase 4d {vmap_4d:.4f}, "
          f"seeded random scores {rand_map:.4f}); device-memory peak "
          f"{peak / 2**30:.2f} GiB; launches {launches} (phase 4d "
          f"{launches_4d})", flush=True)
    assert rc == 0, rc
    assert np.isfinite(vmap) and vmap > rand_map + VOC_MAP_MARGIN, (
        vmap, rand_map)
    for name in ("banded_matmul", "fv_moments"):
        assert launches[name] == launches_4d[name], (launches, launches_4d)

    # a sample of the loaded test items against PIL's decode of the same
    # bytes, bit for bit, with the surrogate's labels
    _release()
    items = voc.voc_loader(VOCDataPath(os.path.join(root, "test"),
                                       voc.IMAGES_PREFIX),
                           VOCLabelPath(labels)).collect()
    want = test.collect()
    assert len(items) == VOC_TEST, len(items)
    picks = np.linspace(0, VOC_TEST - 1, LOADER_SAMPLE).astype(int)
    for i in picks:
        got = items[i]
        pil = np.asarray(Image.open(io.BytesIO(jpegs[i])).convert("RGB"),
                         np.float32)
        assert got.filename == f"{voc.IMAGES_PREFIX}test{i:05d}.jpg", \
            got.filename
        assert got.image.dtype == np.float32 and np.array_equal(
            got.image, pil), i
        assert got.labels == want[i].labels, (got.labels, want[i].labels)
    print(f"[voc-tar] {len(picks)} loaded test items equal PIL's decode of "
          f"their JPEG bytes bit for bit, with the surrogate's labels",
          flush=True)
    del items, want
    _release()
    return launches


def _tar_stream_phase(kernels, workdir, dev):
    """Phase 4n(b) (see the module docstring). Returns the kernel launch
    counts of the traced streamed pass."""
    from keystone_tpu_torch.loaders.image_loader_utils import (
        iter_decoded_chunks,
        stream_tar_images,
    )
    from keystone_tpu_torch.nodes.images.extractors import SIFTExtractor
    from keystone_tpu_torch.observability.trace import PipelineTrace

    rng = np.random.RandomState(SEED)
    base = (rng.rand(LOADER_SIDE, LOADER_SIDE, 3) * 255).astype(np.uint8)
    members = [(f"class{i % 10}/img{i:05d}.jpg",
                np.roll(base, 3 * i, axis=0)) for i in range(LOADER_N)]
    root = os.path.join(workdir, "loader")
    jpegs = _write_tars(root, members, 1)
    tar = os.path.join(root, "part00.tar")
    sift = SIFTExtractor(step=8, bin_size=4, num_scales=2, scale_step=1)

    def featurize(imgs_u8):
        # NTSC grayscale on the card (uint8 wire, float32 compute), one
        # sum an image to keep the copy back small
        f = imgs_u8.to(torch.float32) / 255.0
        gray = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        return torch.stack([sift.apply(g).sum() for g in gray])

    def prepare(batch):
        return np.stack([img for _, img in batch]).astype(np.uint8)

    def serial():
        outs = []
        for batch in iter_decoded_chunks([tar], LOADER_CHUNK):
            outs.append(featurize(torch.as_tensor(prepare(batch)).to(dev)))
        out = torch.cat(outs)
        _sync()
        return out

    def streamed(paths, n=None):
        stream = stream_tar_images(paths, LOADER_CHUNK, prepare=prepare, n=n,
                                   prefetch_depth=LOADER_DEPTH, device=dev)
        out = torch.cat([featurize(c.data[:c.n]) for c in stream.chunks()])
        _sync()
        return out, stream

    def wall(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    want = serial()                      # warm: the kernels' first launches
    streamed([tar], LOADER_N)
    decode_s = wall(lambda: sum(len(b) for b in iter_decoded_chunks(
        [tar], LOADER_CHUNK)))
    serial_s = statistics.median(wall(serial) for _ in range(LOADER_REPS))
    streamed_s = statistics.median(wall(lambda: streamed([tar], LOADER_N))
                                   for _ in range(LOADER_REPS))
    kernels.reset_launches()
    with PipelineTrace("tar-stream") as tr:
        t0 = time.perf_counter()
        got, stream = streamed([tar], LOADER_N)
        traced_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stall = sum(c["ingest_stall_s"] for c in tr.chunks)
    wire = sum(c["h2d_bytes"] for c in tr.chunks) / LOADER_N
    out = {"decode_img_s": LOADER_N / decode_s,
           "serial_img_s": LOADER_N / serial_s,
           "streamed_img_s": LOADER_N / streamed_s,
           "stall_share": stall / traced_s, "wire_bytes": wire}
    err = float((got - want).abs().max() / want.abs().max())
    print(f"[tar-stream] bench.py::loader_bench's path, {LOADER_N} JPEGs of "
          f"{LOADER_SIDE}x{LOADER_SIDE} in one tar, chunks of {LOADER_CHUNK},"
          f" SIFT step 8 bin 4 at 2 scales, medians of {LOADER_REPS}: "
          f"decode only {out['decode_img_s']:.0f} img/s, serial "
          f"(iter_decoded_chunks, copy, SIFT) {out['serial_img_s']:.0f} "
          f"img/s, streamed (stream_tar_images, depth {LOADER_DEPTH}) "
          f"{out['streamed_img_s']:.0f} img/s; the traced streamed pass: "
          f"ingest stall share {out['stall_share']:.4f}, wire "
          f"{wire:.0f} bytes an image ({tr.chunks[0]['nbytes']:.0f} bytes a "
          f"chunk on the card), launches {launches}; streamed against "
          f"serial SIFT sums, max |delta| / max {err:.3e}", flush=True)
    assert wire == LOADER_SIDE * LOADER_SIDE * 3, wire
    assert got.shape == (LOADER_N,) and err <= 1e-6, err
    assert launches["banded_matmul"] == 4 * LOADER_N, launches
    assert stream.n == LOADER_N and stream.quarantine.bad_count == 0

    # one corrupt member, a truncated JPEG, appended to a copy of the tar
    bad = os.path.join(root, "with_corrupt.tar")
    shutil.copy(tar, bad)
    with tarfile.open(bad, "a") as tf:
        _add_member(tf, "class0/truncated.jpg", jpegs[0][:200])
    got_bad, stream_bad = streamed([bad])
    q = stream_bad.quarantine
    print(f"[tar-stream] {LOADER_N + 1} members, one a truncated JPEG: "
          f"{got_bad.shape[0]} images delivered, quarantine bad {q.bad_count}"
          f", ok {q.ok_count}, source {q.records[0]['source']}", flush=True)
    assert q.bad_count == 1 and q.ok_count == LOADER_N, (q.bad_count,
                                                         q.ok_count)
    assert got_bad.shape[0] == stream_bad.n == LOADER_N
    assert float((got_bad - got).abs().max() / got.abs().max()) <= 1e-6
    return launches


def _imagenet_tar_check(kernels, inet, fitted, test, top_4j, err_4j,
                        rand_err, workdir, dev):
    """Phase 4n(c) (see the module docstring), inside phase 4j with its
    fitted predictor. Returns the kernel launch counts of the apply."""
    from keystone_tpu_torch.loaders import imagenet_loader
    from keystone_tpu_torch.workflow.env import PipelineEnv

    root = os.path.join(workdir, "imagenet")
    items = test.collect()
    t0 = time.time()
    _write_tars(os.path.join(root, "test"), [
        (f"n{it.label:05d}/test{i:05d}.JPEG", np.asarray(it.image))
        for i, it in enumerate(items)], INET_TARS)
    labels = os.path.join(root, "labels.txt")
    with open(labels, "w") as f:
        f.write("".join(f"n{c:05d} {c}\n" for c in range(INET_CLASSES)))
    write_s = time.time() - t0
    # the fit's memo of every training image's descriptors is not needed
    # by the apply
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.time()
    loaded = imagenet_loader(os.path.join(root, "test"), labels)
    load_s = time.time() - t0
    test_labels = np.array([it.label for it in loaded.collect()])
    assert np.array_equal(test_labels, [it.label for it in items])
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.time()
    top = torch.stack(fitted(inet.images_on(loaded, dev)).get().collect())
    _sync()
    apply_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    err = _top_k_error(top.cpu().numpy(), test_labels)
    print(f"[imagenet-tar] phase 4j's {INET_TEST} test images as JPEG "
          f"(quality {JPEG_QUALITY}) under n<class>/ in {INET_TARS} tars: "
          f"written in {write_s:.1f} s, imagenet_loader {load_s:.2f} s "
          f"({INET_TEST / load_s:.0f} img/s), apply of 4j's fitted predictor "
          f"{apply_s:.2f} s ({INET_TEST / apply_s:.1f} img/s, device-memory "
          f"peak {peak / 2**30:.2f} GiB); test top-{INET_TOP_K} error "
          f"{err:.4f} (phase 4j from memory {err_4j:.4f}, seeded random "
          f"scores {rand_err:.4f}); launches {launches}", flush=True)
    assert err < rand_err - INET_RANDOM_MARGIN, (err, rand_err)
    assert launches["banded_matmul"] == 10 * INET_TEST, launches
    assert launches["fv_moments"] == 2 * INET_TEST, launches
    del loaded, top
    # the first INET_PNG test images again, lossless: the loader's path
    # must give the in-memory apply's top-k sets
    with ThreadPoolExecutor(8) as pool:
        pngs = list(pool.map(lambda it: _image_bytes(np.asarray(it.image),
                                                     "PNG"), items[:INET_PNG]))
    png_dir = os.path.join(root, "png")
    os.makedirs(png_dir)
    with tarfile.open(os.path.join(png_dir, "part00.tar"), "w") as tf:
        for i, (it, raw) in enumerate(zip(items, pngs)):
            _add_member(tf, f"n{it.label:05d}/test{i:05d}.png", raw)
    loaded = imagenet_loader(png_dir, labels)
    top = torch.stack(fitted(inet.images_on(loaded, dev)).get().collect())
    agree = float(np.mean([set(a) == set(b) for a, b in zip(
        top.cpu().numpy(), top_4j[:INET_PNG])]))
    print(f"[imagenet-tar] the first {INET_PNG} test images as PNG through "
          f"the loader: top-{INET_TOP_K} sets equal to phase 4j's in-memory "
          f"apply on {agree:.4f} of them", flush=True)
    assert agree >= INET_TOP_AGREE, agree
    del loaded, top, pngs
    return launches


def _mnist_csv_phase(workdir):
    """Phase 4n(d) (see the module docstring)."""
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_mnist
    from keystone_tpu_torch.pipelines.images.mnist import random_fft
    from keystone_tpu_torch.workflow.pipeline import Pipeline

    t0 = time.time()
    paths = []
    for split, (X, y) in zip(("train", "test"), make_surrogate_mnist(
            MNIST_CSV_TRAIN, MNIST_CSV_TEST)):
        # MNIST's CSV form: a 1-based label, then 784 pixels in [0, 255]
        rows = np.concatenate([(y + 1)[:, None], np.rint(X * 255)], axis=1)
        paths.append(os.path.join(workdir, f"mnist_{split}.csv"))
        np.savetxt(paths[-1], rows.astype(np.int64), delimiter=",", fmt="%d")
    write_s = time.time() - t0
    _release()
    timer = _StageTimer(timed=True)
    timer.wrap(random_fft, "csv_labeled_loader", "parse")
    timer.wrap(Pipeline, "fit", "fit")
    rc, text, wall = _run_cli(
        ["mnist.random_fft", "--trainLocation", paths[0], "--testLocation",
         paths[1], "--numFFTs", str(MNIST_FFTS), "--blockSize",
         str(MNIST_BLOCK), "--lambda", str(MNIST_LAM)], timer)
    train_err = _printed_number(text, "TRAIN Error is") / 100.0
    test_err = _printed_number(text, "TEST Error is") / 100.0
    parse_s, fit_s = timer.seconds["parse"], timer.seconds["fit"]
    print(f"[mnist-csv] python -m keystone_tpu_torch mnist.random_fft, "
          f"{MNIST_FFTS} FFTs, block {MNIST_BLOCK}, lam {MNIST_LAM}, "
          f"{MNIST_CSV_TRAIN} / {MNIST_CSV_TEST} CSV rows (written in "
          f"{write_s:.1f} s): exit {rc}, {wall:.2f} s in all: CSV parse "
          f"{parse_s:.2f} s (both files), fit {fit_s:.2f} s; train error "
          f"{train_err:.4f}, test error {test_err:.4f}", flush=True)
    assert rc == 0, rc
    assert train_err <= MNIST_TRAIN_ERROR, train_err
    _release()


def _image_nodes_phase(image, dev):
    """Phase 4n(e) (see the module docstring)."""
    from keystone_tpu_torch.nodes.images import DaisyExtractor, HogExtractor
    from keystone_tpu_torch.nodes.learning import ApproximatePCAEstimator

    x = torch.as_tensor(image, device=dev)
    for name, node in (("HOG", HogExtractor()), ("DAISY", DaisyExtractor())):
        first, second = node.apply(x), node.apply(x)
        _sync()
        same = torch.equal(first, second)
        want = node.apply(torch.as_tensor(image))
        err = float((first.cpu() - want).abs().max())
        ms = _time_ms(lambda: node.apply(x), reps=10)
        print(f"[image-nodes] {name} on one {image.shape[0]}x{image.shape[1]}"
              f" image: output {tuple(first.shape)}, {ms:.3f} ms an image on "
              f"the card (median of 10, CUDA events), max |card - CPU| "
              f"{err:.3e} (bar {HOG_DAISY_TOL}), same bits on a second card "
              f"call: {same}", flush=True)
        assert same and err <= HOG_DAISY_TOL, (name, same, err)
    rng = np.random.RandomState(SEED)
    basis = np.linalg.qr(rng.randn(APCA_D, APCA_D))[0]
    X = ((rng.randn(APCA_N, APCA_D) * APCA_DECAY ** np.arange(APCA_D))
         @ basis.T + 5.0).astype(np.float32)
    est = ApproximatePCAEstimator(APCA_DIMS, seed=SEED)
    Xd = torch.as_tensor(X, device=dev)
    on_card = est.approximate_pca(Xd)
    times = []
    for _ in range(3):
        _sync()
        t0 = time.perf_counter()
        est.approximate_pca(Xd)
        _sync()
        times.append(1e3 * (time.perf_counter() - t0))
    on_cpu = est.approximate_pca(X)
    proj = float(np.abs(on_card @ on_card.T - on_cpu @ on_cpu.T).max())
    print(f"[image-nodes] ApproximatePCAEstimator(dims={APCA_DIMS}, q=10, p=5)"
          f" on seeded ({APCA_N}, {APCA_D}) rows (spectrum "
          f"{APCA_DECAY}^i): {statistics.median(times):.1f} ms a fit on the"
          f" card (median of 3, host clock, synchronized); the card's "
          f"subspace against the CPU fit's, max |P_card - P_cpu| {proj:.3e}"
          f" (bar {APCA_TOL})", flush=True)
    assert proj <= APCA_TOL, proj


def _text_stage_timer(app_module, loader, estimator, model):
    """A timed _StageTimer on a text app's stages: the loader, the host
    featurizer (every host stage but the vectorizer), the vectorizer's
    fit and apply, the model's fit and its sparse scoring."""
    from keystone_tpu_torch.nodes.util import (
        CommonSparseFeatures,
        SparseFeatureVectorizer,
    )
    from keystone_tpu_torch.workflow.transformer import HostTransformer

    timer = _StageTimer(timed=True)
    timer.wrap(app_module, loader, "load")
    # the vectorizer first: its own wrapper then calls the unwrapped
    # host-stage path, which the next line wraps for the other stages
    timer.wrap(SparseFeatureVectorizer, "apply_dataset", "vectorize")
    timer.wrap(HostTransformer, "apply_dataset", "featurize")
    timer.wrap(CommonSparseFeatures, "_fit", "vectorizer fit")
    timer.wrap(estimator, "_fit", "model fit")
    timer.wrap(model, "apply_dataset", "model apply")
    return timer


def _stage_line(timer):
    return ", ".join(f"{stage} {s:.2f} s" for stage, s in
                     timer.seconds.items())


def _newsgroups_text_phase(workdir, dev, smi):
    """Phase 4o(a) (see the module docstring). Returns the corpus and the
    fitted featurizer's pieces for 4o(d) and (e)."""
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.loaders.newsgroups import CLASSES
    from keystone_tpu_torch.loaders.surrogate import (
        make_newsgroups_corpus,
        write_newsgroups_split,
    )
    from keystone_tpu_torch.nodes.learning import (
        NaiveBayesEstimator,
        NaiveBayesModel,
    )
    from keystone_tpu_torch.nodes.learning.classifiers import (
        sparse_class_sums,
    )
    from keystone_tpu_torch.nodes.util import CommonSparseFeatures
    from keystone_tpu_torch.nodes.util.sparse import pack_sparse_fit_inputs
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset
    from keystone_tpu_torch.pipelines.text import newsgroups as ng

    n_train, n_test = TEXT_NEWS
    t0 = time.time()
    train_docs, train_y = make_newsgroups_corpus(n_train, 1)
    test_docs, test_y = make_newsgroups_corpus(n_test, 2)
    dirs = [os.path.join(workdir, "20news", s) for s in ("train", "test")]
    for d, docs, y in zip(dirs, (train_docs, test_docs), (train_y, test_y)):
        write_newsgroups_split(d, docs, y)
    print(f"[text] (a) surrogate 20 Newsgroups corpus, {n_train} / {n_test} "
          f"documents of 40 words, made and written one file a document in "
          f"{time.time() - t0:.1f} s", flush=True)

    _release()
    vec_rec = _Recorder(CommonSparseFeatures, "_fit")
    fit_rec = _Recorder(NaiveBayesEstimator, "_fit")
    timer = _text_stage_timer(ng, "newsgroups_loader", NaiveBayesEstimator,
                              NaiveBayesModel)
    try:
        rc, text, wall = _run_cli(
            ["text.newsgroups", "--trainLocation", dirs[0], "--testLocation",
             dirs[1]], timer)
    finally:
        fit_rec.close()
        vec_rec.close()
    assert rc == 0, rc
    err = _printed_number(text, "TEST Error is") / 100.0
    vec = vec_rec.results[0][1]
    (train_sv, labels), (est, model) = fit_rec.calls[0], fit_rec.results[0]
    idx, vals, d, y = pack_sparse_fit_inputs(train_sv, labels)
    nnz = int(np.count_nonzero(vals))
    # the loader reads a split class by class, so its labels are sorted
    rand_err = float(np.mean(np.random.RandomState(SEED).rand(
        n_test, len(CLASSES)).argmax(1) != np.sort(test_y)))
    print(f"[text] (a) python -m keystone_tpu_torch text.newsgroups "
          f"(bigrams, {len(vec.feature_space)} features kept of 100,000, "
          f"naive Bayes lam {est.lam} on the card): exit {rc}, {wall:.2f} s "
          f"in all, {(n_train + n_test) / wall:.0f} documents/s; "
          f"{_stage_line(timer)}; training nnz {nnz}; test error {err:.4f} "
          f"(seeded random scores {rand_err:.4f}) | {smi}", flush=True)
    assert 0.02 < err < 0.90, err
    assert err <= rand_err - TEXT_RANDOM_MARGIN, (err, rand_err)

    # the fit again from its own inputs: the sums and the model's bits
    sums = [sparse_class_sums(idx, vals, d, y, est.num_classes, dev)
            for _ in range(2)]
    again = est._fit(train_sv, labels)
    score_pairs = ng.featurizer(ng.NewsgroupsConfig())(
        HostDataset(test_docs[:TEXT_SCORE_DOCS])).get()
    score_sv = vec.apply_dataset(score_pairs)
    scores = [m.apply_dataset(score_sv).data[:TEXT_SCORE_DOCS]
              for m in (model, again)]
    _sync()
    same = (torch.equal(sums[0], sums[1])
            and torch.equal(model.pi, again.pi)
            and torch.equal(model.theta, again.theta)
            and torch.equal(scores[0], scores[1]))
    print(f"[text] (a) a second naive Bayes fit on the card: float64 class "
          f"sums ({tuple(sums[0].shape)}), pi, theta and the scores of "
          f"{TEXT_SCORE_DOCS} test documents the same bits: {same}",
          flush=True)
    assert same

    # the same documents through the CPU path, in process
    _release()
    vec_rec = _Recorder(CommonSparseFeatures, "_fit")
    fit_rec = _Recorder(NaiveBayesEstimator, "_fit")
    try:
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            ng.run(ng.NewsgroupsConfig(dirs[0]), test=LabeledData(
                HostDataset(test_docs[:TEXT_SCORE_DOCS]),
                ArrayDataset.from_numpy(test_y[:TEXT_SCORE_DOCS], "cpu")),
                device="cpu")
        cpu_s = time.time() - t0
    finally:
        fit_rec.close()
        vec_rec.close()
    vec_cpu = vec_rec.results[0][1]
    model_cpu = fit_rec.results[0][1]
    same_map = (list(vec_cpu.feature_space.items())
                == list(vec.feature_space.items()))
    cpu_scores = model_cpu.apply_dataset(
        vec_cpu.apply_dataset(score_pairs)).data[:TEXT_SCORE_DOCS]
    card = scores[0].cpu()
    score_err = float((card - cpu_scores).abs().max()
                      / cpu_scores.abs().max())
    same_argmax = torch.equal(card.argmax(1), cpu_scores.argmax(1))
    print(f"[text] (a) the same {TEXT_SCORE_DOCS} test documents through "
          f"run(device='cpu') ({cpu_s:.2f} s, the fit included): the same "
          f"feature -> index map: {same_map}; scores card against CPU "
          f"{score_err:.3e} of the largest (bar {NB_CPU_SCORE_TOL}), the "
          f"same argmax: {same_argmax}", flush=True)
    assert same_map and same_argmax and score_err <= NB_CPU_SCORE_TOL
    _release()
    return {"train_docs": train_docs, "train_y": train_y,
            "test_docs": test_docs, "test_y": test_y}


def _amazon_text_phase(workdir, dev, smi):
    """Phase 4o(b) (see the module docstring)."""
    from keystone_tpu_torch.loaders.surrogate import (
        make_amazon_corpus,
        write_amazon_reviews,
    )
    from keystone_tpu_torch.nodes.learning import (
        LogisticRegressionEstimator,
        LogisticRegressionModel,
    )
    from keystone_tpu_torch.nodes.learning.classifiers import (
        sparse_logistic_objective,
    )
    from keystone_tpu_torch.nodes.util import CommonSparseFeatures
    from keystone_tpu_torch.nodes.util.sparse import (
        CSRMatrix,
        pack_sparse_fit_inputs,
    )
    from keystone_tpu_torch.ops.lbfgs import lbfgs
    from keystone_tpu_torch.pipelines.text import amazon_reviews as am

    n_train, n_test = TEXT_AMAZON
    t0 = time.time()
    paths = [os.path.join(workdir, f"amazon_{s}.json")
             for s in ("train", "test")]
    for path, (n, seed) in zip(paths, ((n_train, 1), (n_test, 2))):
        reviews, y = make_amazon_corpus(n, seed)
        write_amazon_reviews(path, reviews, y, seed=seed)
    print(f"[text] (b) surrogate Amazon reviews, {n_train} / {n_test} "
          f"reviews of 40 words, made and written as JSON lines in "
          f"{time.time() - t0:.1f} s", flush=True)

    _release()
    vec_rec = _Recorder(CommonSparseFeatures, "_fit")
    fit_rec = _Recorder(LogisticRegressionEstimator, "_fit")
    timer = _text_stage_timer(am, "amazon_reviews_loader",
                              LogisticRegressionEstimator,
                              LogisticRegressionModel)
    try:
        rc, text, wall = _run_cli(
            ["text.amazon_reviews", "--trainLocation", paths[0],
             "--testLocation", paths[1]], timer)
    finally:
        fit_rec.close()
        vec_rec.close()
    assert rc == 0, rc
    err = _printed_number(text, "TEST Error is") / 100.0
    vec = vec_rec.results[0][1]
    (train_sv, labels), (est, model) = fit_rec.calls[0], fit_rec.results[0]
    stats = model._solve_stats
    idx, vals, d, y = pack_sparse_fit_inputs(train_sv, labels)
    print(f"[text] (b) python -m keystone_tpu_torch text.amazon_reviews "
          f"(bigrams, {len(vec.feature_space)} features, logistic "
          f"regression, {est.num_iters} iterations at most, on the card): "
          f"exit {rc}, {wall:.2f} s in all, {(n_train + n_test) / wall:.0f} "
          f"documents/s; {_stage_line(timer)}; L-BFGS {stats['iterations']} "
          f"iterations, {stats['evaluations']} evaluations, "
          f"{stats['line_search_steps']} backtracking steps; training nnz "
          f"{int(np.count_nonzero(vals))}; test error {err:.4f} | {smi}",
          flush=True)
    assert AMAZON_ERROR_BAND[0] < err < AMAZON_ERROR_BAND[1], err

    again = est._fit(train_sv, labels)
    same = torch.equal(model.weights, again.weights)
    A = CSRMatrix.from_padded(idx, vals, d, dev, torch.float64)
    t0 = time.time()
    res = lbfgs(sparse_logistic_objective(A, A.transpose(), y,
                                          est.num_classes,
                                          float(est.reg_param)),
                torch.zeros((d, est.num_classes), dtype=torch.float64,
                            device=dev),
                max_iters=stats["iterations"], tol=0.0)
    _sync()
    f64_s = time.time() - t0
    W64 = res.x
    rel = float((model.weights.double() - W64).abs().max()
                / W64.abs().max())
    print(f"[text] (b) a second fit on the card the same bits: {same}; the "
          f"same L-BFGS in float64 on the same CSR matrix ({res.num_iters} "
          f"iterations, {f64_s:.2f} s): weights {rel:.3e} of the largest "
          f"from it (bar {LR_F64_TOL})", flush=True)
    assert same and res.num_iters == stats["iterations"]
    assert rel <= LR_F64_TOL, rel
    _release()


def _backoff_text_phase(workdir, dev, smi):
    """Phase 4o(c) (see the module docstring)."""
    from keystone_tpu_torch.loaders.surrogate import make_backoff_corpus
    from keystone_tpu_torch.pipelines.nlp import stupid_backoff_pipeline as sb

    path = os.path.join(workdir, "backoff.txt")
    with open(path, "w") as f:
        f.write("\n".join(make_backoff_corpus(TEXT_BACKOFF_LINES)) + "\n")
    config = sb.StupidBackoffConfig(path, n=3)
    models, walls = {}, {}
    for device in ("card", "cpu"):
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()):
            models[device] = sb.run(config, device=(
                dev if device == "card" else "cpu"))
        walls[device] = time.time() - t0
    model = models["card"]
    same = (model.scores == models["cpu"].scores
            and model.num_tokens == models["cpu"].num_tokens)
    print(f"[text] (c) StupidBackoff run(device={str(dev)!r}), n = 3 on "
          f"{TEXT_BACKOFF_LINES} Zipf lines of 20 words: {model.num_tokens} "
          f"tokens, vocabulary {len(model.unigram_counts)}, "
          f"{len(model.scores)} n-grams scored in {walls['card']:.2f} s, "
          f"{len(model.scores) / walls['card']:.0f} n-grams/s (host work); "
          f"scores equal to run(device='cpu')'s ({walls['cpu']:.2f} s): "
          f"{same} | {smi}", flush=True)
    assert same


def _lemma_text_phase(news, dev, smi):
    """Phase 4o(d) (see the module docstring)."""
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset
    from keystone_tpu_torch.pipelines.text import newsgroups as ng

    n = TEXT_LEMMA_DOCS
    train, test = (LabeledData(HostDataset(news[f"{s}_docs"][:n]),
                               ArrayDataset.from_numpy(news[f"{s}_y"][:n],
                                                       dev))
                   for s in ("train", "test"))
    _release()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        _, ev = ng.run(ng.NewsgroupsConfig(lemmatize=True), train, test,
                       num_classes=20, device=dev)
    _sync()
    wall = time.time() - t0
    print(f"[text] (d) lemmatized Newsgroups (perceptron POS and NER, "
          f"bigrams) on the first {n} training and {n} test documents of "
          f"(a): {wall:.2f} s, {1e3 * wall / (2 * n):.2f} ms a document; "
          f"test error {ev.total_error:.4f} | {smi}", flush=True)
    assert 0.02 < ev.total_error < 0.90, ev.total_error
    _release()


def _native_text_phase(news, hashing_calls, smi):
    """Phase 4o(e) (see the module docstring)."""
    from keystone_tpu_torch import native
    from keystone_tpu_torch.nodes.nlp import NGramsHashingTF, Tokenizer
    from keystone_tpu_torch.nodes.nlp.hashing import ngram_feature_indices

    assert native.available(), native.build_error()
    path = native.loaded_path()
    build_dir = os.path.join(REPO, "build", "keystone_tpu_torch")
    assert os.path.realpath(os.path.dirname(path)) == os.path.realpath(
        build_dir), path
    tokens = [Tokenizer().apply(d.lower())
              for d in news["train_docs"][:TEXT_HASH_DOCS]]
    width = 1 << 20
    native.reset_calls()
    t0 = time.perf_counter()
    fast = [native.ngram_hash_features(t, [1, 2], width) for t in tokens]
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = [ngram_feature_indices(t, 1, 2, width) for t in tokens]
    python_s = time.perf_counter() - t0
    equal = all(np.array_equal(a, b) for a, b in zip(fast, slow))
    node = NGramsHashingTF([1, 2], width)
    for t in tokens:
        node.apply(t)
    calls = native.CALLS["ngram_hash_features"]
    print(f"[text] (e) native host shim {os.path.relpath(path, REPO)}: "
          f"n-gram hash features of {TEXT_HASH_DOCS} documents of (a) "
          f"native {1e3 * native_s:.1f} ms, pure Python "
          f"{1e3 * python_s:.1f} ms, equal: {equal}; NGramsHashingTF's "
          f"calls by branch {calls}; (a)'s own hashing calls by branch "
          f"{hashing_calls} (the Newsgroups path hashes nothing) | {smi}",
          flush=True)
    assert equal
    assert calls == {"native": 2 * TEXT_HASH_DOCS, "python": 0}, calls
    assert hashing_calls["python"] == 0, hashing_calls


def _text_phase(kernels, workdir, dev, smi):
    """Phase 4o (see the module docstring). Returns its seconds."""
    from keystone_tpu_torch import native

    t0 = time.time()
    kernels.reset_launches()
    native.reset_calls()
    news = _newsgroups_text_phase(workdir, dev, smi)
    hashing_calls = dict(native.CALLS["ngram_hash_features"])
    _amazon_text_phase(workdir, dev, smi)
    _backoff_text_phase(workdir, dev, smi)
    _lemma_text_phase(news, dev, smi)
    launches = dict(kernels.LAUNCHES)
    _native_text_phase(news, hashing_calls, smi)
    seconds = time.time() - t0
    print(f"[text] phase 4o took {seconds:.1f} s; kernel launches "
          f"{launches} (the text path runs none of the five)", flush=True)
    assert not any(launches.values()), launches
    return seconds


def _lanes_disjoint(events):
    """True when no lane of a Chrome trace holds two overlapping spans."""
    by_lane = {}
    for e in events:
        if e.get("ph") == "X":
            by_lane.setdefault(e["tid"], []).append((e["ts"], e["dur"]))
    for spans in by_lane.values():
        spans.sort()
        for (t0, d0), (t1, _) in zip(spans, spans[1:]):
            if t1 < t0 + d0 - 1e-3:
                return False
    return True


def _resilience_phase(kernels, rpc, tr_x, tr_y, filters, whitener, config,
                      featurizer, ref, workdir, dev, smi):
    """Phase 4l: the resilience and telemetry planes on phase 4b's
    streamed fit at full width (20 chunks of 1024 f32 images, 8192
    features), through ``Estimator.fit`` / ``LabelEstimator.fit`` with
    stream options: an uninterrupted fit, one killed at chunk 10 with a
    snapshot every 4 chunks and resumed bit-identically, transient
    staging faults absorbed by retries, a poisoned chunk caught by the
    numerics tripwire, a traced pipeline fit's timeline, and the planes'
    costs. Returns the gram_cross launches of the resumed fit."""
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
    )
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.observability.numerics import (
        NumericsError,
        numerics_suppressed,
    )
    from keystone_tpu_torch.observability.sampler import TelemetrySampler
    from keystone_tpu_torch.observability.timeline import (
        flight_recorder,
        write_trace_artifact,
    )
    from keystone_tpu_torch.observability.trace import PipelineTrace
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.resilience import (
        FaultPlan,
        RetryExhaustedError,
        RetryPolicy,
    )
    from keystone_tpu_torch.workflow.common import Cacher
    from keystone_tpu_torch.workflow.env import PipelineEnv

    n_chunks = -(-N_TRAIN // CHUNK)
    budget = (DEPTH + 1) * CHUNK * 32 * 32 * 3 * 4 + (1 << 20)
    labels_int = ArrayDataset.from_numpy(tr_y.astype(np.int32), dev)
    labels = ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES
                                               ).apply_dataset(labels_int)
    ck = os.path.join(workdir, "ck")
    reg = MetricsRegistry.get_or_create()

    def stream(policy=None):
        return featurizer.apply_dataset(StreamingDataset.from_numpy(
            tr_x, CHUNK, device=dev, prefetch_depth=DEPTH, tag="cifar-train",
            hbm_budget=budget, retry_policy=policy))

    def fit(checkpoint=False, solver_plan=None, policy=None):
        """StandardScaler, then BlockLeastSquaresEstimator(4096, 1, 10),
        on the featurized stream; the plan is active over the solver's
        fit only. Returns (scaler model, mapper, seconds)."""
        feats = stream(policy)
        opts = {}
        t0 = time.time()
        if checkpoint:
            opts = dict(checkpoint_dir=os.path.join(ck, "scaler"),
                        checkpoint_every=4)
        scaler = StandardScaler().fit(feats, **opts)
        if checkpoint:
            opts = dict(checkpoint_dir=os.path.join(ck, "solver"),
                        checkpoint_every=4)
        est = BlockLeastSquaresEstimator(BLOCK, PASSES, float(config.lam))
        with solver_plan or contextlib.nullcontext():
            model = est.fit(scaler.apply_dataset(feats), labels, **opts)
        _sync()
        return scaler, model, time.time() - t0

    def same(a, b):
        return torch.equal(torch.as_tensor(np.asarray(a)),
                           torch.as_tensor(np.asarray(b)))

    def weights(model):
        return torch.as_tensor(model.weights).float()

    # -- uninterrupted, with the telemetry sampler at 0.1 s ---------------
    sampler = TelemetrySampler(interval_s=0.1).start()
    scaler_u, model_u, t_u = fit()
    sampler.stop()
    sampler.stop()  # idempotent
    W_u = weights(model_u)
    same_4b = (torch.equal(W_u, ref["W"]) and same(scaler_u.mean, ref["mean"])
               and same(scaler_u.std, ref["std"]))
    w_rel = float((W_u - ref["W"]).abs().max() / ref["W"].abs().max())
    print(f"[4l] uninterrupted fit through Estimator.fit / "
          f"LabelEstimator.fit: {t_u:.3f} s; same bits as phase 4b's "
          f"pipeline weights and scaler: {same_4b} (max |dW| / max |W| "
          f"{w_rel:.3e}) | {smi}", flush=True)
    if not same_4b:
        print("[4l] the pipeline fuses the scaler into the featurize "
              "node's chunk transform; the direct fits apply them one "
              "after the other", flush=True)
        assert w_rel <= W_STREAM_RESIDENT_TOL, w_rel
    names = sampler.series_names()
    probes = ("process.rss_bytes", "numerics.health_age_s",
              "streaming.stage_queue_depth")
    print(f"[4l] TelemetrySampler at 0.1 s: "
          f"{len(sampler.series('process.rss_bytes'))} ticks, "
          f"{len(names)} series: {', '.join(names)}", flush=True)
    assert all(p in names for p in probes), names

    # -- kill at chunk 10 of the solver's fit, a snapshot every 4 chunks --
    before = len(flight_recorder().spans())
    kill = FaultPlan().add("ingest.produce", after=10, count=1,
                           error=RuntimeError)
    try:
        fit(checkpoint=True, solver_plan=kill)
        raise AssertionError("the killed fit did not raise")
    except RuntimeError as exc:
        assert "injected fault at ingest.produce" in str(exc), exc
    snap_path = os.path.join(ck, "solver", "stream_fit.ckpt")
    with open(snap_path, "rb") as f:
        cursor = int(pickle.load(f)["cursor"])
    saves = [s.args for s in flight_recorder().spans()[before:]
             if s.name == "checkpoint_save"]
    print(f"[4l] killed at chunk 10 of {n_chunks}: snapshot on disk at "
          f"cursor {cursor}; {len(saves)} saves (scaler 5, solver 2): "
          + ", ".join(f"cursor {a['cursor']} d2h {a['d2h_s']:.4f} s write "
                      f"{a['write_s']:.4f} s" for a in saves)
          + f" | {smi}", flush=True)
    assert cursor == 8, cursor
    assert not os.path.exists(os.path.join(ck, "scaler", "stream_fit.ckpt"))

    # -- resume under a trace -------------------------------------------------
    restore_before = reg.histogram("checkpoint.restore_s").snapshot()["count"]
    kernels.reset_launches()
    with PipelineTrace("4l-resume") as tr:
        scaler_r, model_r, t_r = fit(checkpoint=True)
    resumed = dict(kernels.LAUNCHES)
    restore = reg.histogram("checkpoint.restore_s").snapshot()
    bits = (torch.equal(weights(model_r), W_u)
            and same(scaler_r.mean, scaler_u.mean)
            and same(scaler_r.std, scaler_u.std))
    print(f"[4l] resumed from cursor {cursor}: {t_r:.3f} s (uninterrupted "
          f"{t_u:.3f} s), restore {restore['max']:.4f} s, W and scaler "
          f"torch.equal to the uninterrupted fit's: {bits}; launches "
          f"{resumed} (gram_cross {n_chunks} - {cursor}; featurize: the "
          f"scaler's {n_chunks} and the solver's {n_chunks}, replayed "
          f"chunks featurized again); resilience events "
          f"{tr.resilience_stats} | {smi}", flush=True)
    assert bits
    assert restore["count"] == restore_before + 1
    assert tr.resilience_stats.get("checkpoint_restore") == 1, \
        tr.resilience_stats
    assert resumed["gram_cross"] == n_chunks - cursor, resumed
    assert not os.path.exists(snap_path)

    # -- transient staging faults --------------------------------------------
    # rate 0.3 under the default policy (3 attempts): three faults in a
    # row, 2.7% a chunk, come at chunk 14 of seed 0's draws
    flaky = FaultPlan(seed=0).add("ingest.stage", kind="error", rate=0.3)
    try:
        with flaky:
            fit()
        raise AssertionError("the default policy did not exhaust")
    except RetryExhaustedError as exc:
        pm = exc.postmortem_path
        print(f"[4l] default RetryPolicy (3 attempts) at rate 0.3, seed 0: "
              f"exhausted after {flaky.injections()} faults, post-mortem "
              f"{os.path.basename(pm)}", flush=True)
        assert pm and os.path.exists(pm)
    flaky = FaultPlan(seed=0).add("ingest.stage", kind="error", rate=0.3)
    with flaky:
        _, model_f, t_f = fit(policy=RetryPolicy(max_attempts=5))
    print(f"[4l] RetryPolicy(max_attempts=5) at rate 0.3, seed 0: "
          f"{flaky.injections()} staging faults retried, {t_f:.3f} s, same "
          f"bits as the uninterrupted fit: "
          f"{torch.equal(weights(model_f), W_u)}", flush=True)
    assert flaky.injections() > 0
    assert torch.equal(weights(model_f), W_u)

    # -- a poisoned chunk ----------------------------------------------------
    poison = FaultPlan().add("ingest.stage", kind="corrupt", after=5,
                             count=1)
    before = len(flight_recorder().spans())
    try:
        with poison:
            fit()
        raise AssertionError("the poisoned chunk was not caught")
    except NumericsError as exc:
        msg, pm = str(exc), exc.postmortem_path
    last = max(s.args["chunk"] for s in flight_recorder().spans()[before:]
               if s.name == "accumulate:cifar-train")
    with open(pm) as f:
        series = json.load(f)["context"]["recent_health"]
    print(f"[4l] NaN in chunk 5's first pixel: NumericsError after the "
          f"accumulate of chunk {last}: {msg[:120]}...; post-mortem "
          f"{os.path.basename(pm)} holds {len(series)} health entries",
          flush=True)
    assert "chunk 5 of stream 'cifar-train'" in msg, msg
    assert last <= 5 + 8, last
    assert any(e.get("chunk") == 5 and e["nan"] > 0 for e in series), series

    # -- numerics overhead: interleaved pairs ----------------------------------
    shares = []
    for i in range(NUMERICS_PAIRS):
        legs = {}
        for off in ((False, True) if i % 2 == 0 else (True, False)):
            with numerics_suppressed() if off else contextlib.nullcontext():
                legs[off] = fit()[2]
        shares.append((legs[False] - legs[True]) / legs[True])
    # the plane's pieces a chunk, at the chunk's shape: the health word
    # of the featurized chunk and its labels, and the sketch's update
    from keystone_tpu_torch.observability import numerics as num
    from keystone_tpu_torch.tools import device_ms

    Xf = featurizer.apply_batch(torch.as_tensor(tr_x[:CHUNK], device=dev))
    Yl = labels.data[:CHUNK]
    sk = num.SketchTracker()
    sk.update(ArrayDataset(Xf, CHUNK))
    monitor = num.HealthMonitor("4l")
    for _ in range(2):  # the second chunk of a geometry captures the graph
        monitor._replayed_word([Xf, Yl])
    pieces = {
        "health word, eager": (lambda: num.health_word(
            (Xf, Yl), rows=(CHUNK, CHUNK)), device_ms),
        "health word, the monitor's graph (copy + replay)": (
            lambda: monitor._replayed_word([Xf, Yl]), _events_ms),
        "sketch update": (lambda: num._sketch_update(
            sk._counts, *sk._dev[1:], sk._dev[0], Xf), device_ms)}
    costs = ", ".join(f"{k} device {timer(f):.4f} ms, host "
                      f"{_host_us(f):.1f} us" for k, (f, timer)
                      in pieces.items())
    print(f"[4l] numerics plane a chunk ({CHUNK} x {Xf.shape[1]} and its "
          f"labels): {costs} | {smi}", flush=True)
    del Xf, Yl, sk, pieces, monitor
    print(f"[4l] numerics plane overhead, median of {NUMERICS_PAIRS} "
          f"interleaved pairs: "
          f"{statistics.median(shares) * 100:.2f}% of the fit (pairs: "
          + ", ".join(f"{x * 100:.2f}%" for x in shares) + f") | {smi}",
          flush=True)

    # -- the timeline of a traced pipeline fit ---------------------------------
    PipelineEnv.reset()
    flight_recorder().clear()
    plabels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
               >> Cacher("labels"))(labels_int)
    pstream = StreamingDataset.from_numpy(
        tr_x, CHUNK, device=dev, prefetch_depth=DEPTH, tag="cifar-train",
        hbm_budget=budget)
    with PipelineTrace("4l-timeline") as tr:
        rpc.build_pipeline(filters, whitener, config, pstream,
                           plabels).fit()
    path = os.path.join(workdir, "4l.perfetto.json")
    write_trace_artifact(path, tr)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    lanes = {}
    for kind in ("stage", "stall", "accumulate", "node"):
        mine = [e for e in spans if e["name"].startswith(kind + ":")
                or (kind == "node" and e["cat"] == "node")]
        lanes[kind] = (len(mine), {e["tid"] for e in mine})
    print("[4l] traced pipeline fit's Chrome trace: " + ", ".join(
        f"{k} {n} spans on lanes {sorted(t)}" for k, (n, t) in lanes.items())
        + f"; {len(tr.nodes)} node records", flush=True)
    assert all(n > 0 for n, _ in lanes.values()), lanes
    assert not lanes["stage"][1] & (lanes["stall"][1]
                                   | lanes["accumulate"][1]), lanes
    assert _lanes_disjoint(events)
    PipelineEnv.reset()
    return resumed["gram_cross"]


def _fit_seconds(fit, reps=3):
    """Median seconds of ``fit()`` (the card synchronized on both sides)
    over ``reps`` runs, and the last run's model."""
    times = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        model = fit()
        _sync()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), model


def _candidates(label, est, X, Y, fits):
    """Fit each named candidate on the same (X, Y) ArrayDatasets; print
    its seconds beside its cost on the estimator's surface, and whether
    the cost order is the measured order (evidence for a calibration on
    the card, not asserted). Returns {name: seconds} and {name: model}."""
    n, d, k = X.n, X.data.shape[1], Y.data.shape[1]
    costs = {type(s).__name__: c for c, s, _ in est.costs(n, d, k, 1.0, 1)}
    secs, models = {}, {}
    for name, solver in fits.items():
        secs[name], model = _fit_seconds(lambda: solver.fit(X, Y))
        models[name] = model
        stats = getattr(model, "_solve_stats", None)
        print(f"[solver] {label} ({n}, {d}, {k}): {name} fit "
              f"{secs[name]:.4f} s (median of 3), EC2 cost "
              f"{costs[name]:.4g}{f'; L-BFGS {stats}' if stats else ''}",
              flush=True)
    by_cost = sorted(secs, key=lambda name: costs[name])
    by_time = sorted(secs, key=lambda name: secs[name])
    print(f"[solver] {label}: cost order {by_cost}, measured order "
          f"{by_time}; cost model's order matches measured: "
          f"{by_cost == by_time}", flush=True)
    return secs, models


def _solver_accuracy(models, X, Y, X_test, te_y, lam):
    """Each fitted candidate's test error beside how far its weights lie
    from the exact float64 minimizer of its own objective, max |W -
    W_exact| / max |W_exact|: the BCDs and the exact solver minimize
    |Xc W - Yc|^2 + lam |W|^2, the L-BFGS solver the same with its terms
    divided by n, whose minimizer is the first's at lam * n. Returns
    {name: (test error, distance)}."""
    n = X.n
    Y = Y.data[:n]
    exact = {"ridge": _ridge_float64(X.data, Y, lam / n),
             "per-n": _ridge_float64(X.data, Y, lam)}
    out = {}
    for name, model in models.items():
        W = torch.as_tensor(model.weights).to(X.data.device)
        ref = exact["per-n" if "LBFGS" in name else "ridge"]
        pred = model.apply_batch(X_test.data).argmax(dim=1).cpu().numpy()
        out[name] = (float(np.mean(pred != te_y)), _rel(W, ref))
    ridge = exact["ridge"]
    # the exact minimizer's own test error, as a float32 mapper would score
    # it: the intercept is the label mean less the feature means times W
    Xm, Ym = X.data.double().mean(dim=0), Y.double().mean(dim=0)
    scores = (X_test.data.double() - Xm) @ ridge + Ym
    out["float64 exact ridge"] = (
        float(np.mean(scores.argmax(dim=1).cpu().numpy() != te_y)), 0.0)
    print("[solver] test error and max |W - W_exact| / max |W_exact| (the "
          "float64 minimizer of the solver's own objective) at lam = "
          f"{lam}: " + "; ".join(f"{name} {err:.4f}, {dist:.3e}"
                                 for name, (err, dist) in out.items()),
          flush=True)
    del exact, ridge, scores
    return out


def _sparse_dataset(n, d, nnz, seed):
    """Seeded host SparseVectors at density about nnz / d (duplicate
    draws coalesce), and +-1 indicators of 10 classes given by the argmax
    of a seeded linear score of each row. Returns the items and the
    (n, 10) labels as numpy."""
    from keystone_tpu_torch.nodes.util.sparse import SparseVector

    rng = np.random.RandomState(seed)
    idx = rng.randint(0, d, (n, nnz))
    vals = rng.randn(n, nnz).astype(np.float32)
    W = rng.randn(d, 10).astype(np.float32)
    y = np.einsum("rs,rsk->rk", vals, W[idx]).argmax(axis=1)
    Y = np.where(np.arange(10) == y[:, None], 1.0, -1.0).astype(np.float32)
    return [SparseVector(idx[i], vals[i], d) for i in range(n)], Y


def _ridge_float64(X, Y, lam):
    """The exact minimizer of the L-BFGS solvers' objective with an
    intercept, in float64: (Xc^T Xc / n + lam I)^-1 Xc^T Yc / n."""
    X, Y = X.to(torch.float64), Y.to(torch.float64)
    X = X - X.mean(dim=0)
    Y = Y - Y.mean(dim=0)
    n, d = X.shape
    G = X.T @ X / n + lam * torch.eye(d, dtype=X.dtype, device=X.device)
    return torch.linalg.solve(G, X.T @ Y / n)


def _rel(a, b):
    """max |a - b| / max |b|, float64."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    return float((a - b).abs().max() / b.abs().max())


def _chosen_cifar(rpc, filters, whitener, config, train, labels):
    """RandomPatchCifar's predictor (``rpc.build_pipeline``) with a
    LeastSquaresEstimator in place of the app's BlockLeastSquaresEstimator
    (4096, 1), so that the node-level rule chooses the solver."""
    from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool
    from keystone_tpu_torch.nodes.learning import LeastSquaresEstimator
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.nodes.util import MaxClassifier
    from keystone_tpu_torch.workflow.common import Cacher

    featurizer = FusedConvRectifyPool(
        filters, rpc.IMAGE_SIZE, config.patch_size, rpc.NUM_CHANNELS,
        config.pool_stride, config.pool_size, config.alpha,
        whitener=whitener) >> Cacher("features")
    return (featurizer.and_then(StandardScaler(), train)
            .and_then(LeastSquaresEstimator(lam=config.lam), train, labels)
            >> MaxClassifier())


class _PlanProbe:
    """Each ``Pipeline.fit`` while it is open: the raw graph it was given,
    the device memory allocated when it started and the device-memory peak
    when it returned (the peak counter the phase resets before its fit).
    ``plan`` runs the static planner over one recorded graph and lets the
    graph go; ``close`` removes the wrapper."""

    def __init__(self):
        from keystone_tpu_torch.workflow.pipeline import Pipeline

        self.fits = []
        self._real = Pipeline.__dict__["fit"]
        probe = self

        def fit(pipe):
            base = torch.cuda.memory_allocated()
            out = probe._real(pipe)
            _sync()
            probe.fits.append({"graph": pipe.graph, "base": base,
                               "peak": torch.cuda.max_memory_allocated()})
            return out

        Pipeline.fit = fit

    def close(self):
        from keystone_tpu_torch.workflow.pipeline import Pipeline

        Pipeline.fit = self._real

    def plan(self, label, index=0):
        """(plan, base, peak) of the recorded fit at ``index``; every
        recorded graph is dropped."""
        from keystone_tpu_torch.analysis import analyze, plan_graph

        rec = self.fits[index]
        t0 = time.time()
        # what the port's executor holds: every value to the end
        plan = plan_graph(analyze(rec["graph"]), label, memo_held=True)
        plan.seconds = time.time() - t0
        self.fits = []
        return plan, rec["base"], rec["peak"]


def _plan_line(label, plan, base, peak):
    mib = 2 ** 20
    print(f"[4p] plan against the card, {label}: static fit-path peak "
          f"{plan.fit_peak_nbytes / mib:.1f} MiB (node {plan.peak_node}; "
          f"{len(plan.unresolved)} unresolved; planned in "
          f"{plan.seconds:.2f} s), measured device-memory peak "
          f"{peak / mib:.1f} MiB ({(peak - base) / mib:.1f} MiB above the "
          f"{base / mib:.1f} MiB allocated when the fit began); plan / "
          f"peak {plan.fit_peak_nbytes / max(peak, 1):.3f}", flush=True)


def _analysis_phase(kernels, rpc, tr_x, tr_y, te_x, te_y, filters, whitener,
                    config, static_4e, rules, workdir, dev):
    """Phase 4p (see the module docstring): the node rule's sampled
    opt-out on 4e's resident fit, the provenance of 4d's and 4j's
    choices, ``check --all`` in process, a traced CIFAR run through the
    command line and its per-node MFU, and the ``numerics`` and
    ``benchdiff`` commands."""
    from keystone_tpu_torch import __main__ as cli
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.util import ClassLabelIndicatorsFromIntLabels
    from keystone_tpu_torch.ops import work
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.workflow.common import Cacher
    from keystone_tpu_torch.workflow.env import PipelineEnv

    t_phase = time.time()
    # (a) the sampled path, driven on 4e's resident fit
    train_x = ArrayDataset.from_numpy(tr_x, dev)
    labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
              >> Cacher("labels"))(
        ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))
    PipelineEnv.reset()
    os.environ["KEYSTONE_TORCH_STATIC_NODE_OPT"] = "0"
    clock = _RuleClock(kernels)
    kernels.reset_launches()
    t0 = time.time()
    try:
        fitted = _chosen_cifar(rpc, filters, whitener, config, train_x,
                               labels).fit()
        _sync()
    finally:
        clock.close()
        del os.environ["KEYSTONE_TORCH_STATIC_NODE_OPT"]
    fit_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    (rule,) = [c for c in clock.choices if not c["streaming"]]
    (node,) = [c for c in clock.nodes if c["node"] == "LeastSquaresEstimator"]
    n, d, k, density, _ = rule["args"]
    choice = rule["choice"]
    sample_fz = node["sample_launches"].get("fused_cifar_featurize", 0)
    pred = fitted.apply(ArrayDataset.from_numpy(te_x, dev)).get()
    err = evaluate_multiclass(pred, te_y, rpc.NUM_CLASSES).total_error
    print(f"[4p] KEYSTONE_TORCH_STATIC_NODE_OPT=0 on 4e's resident fit: "
          f"provenance {node['provenance']}, sampled density {density:.6f} "
          f"(static: {static_4e['density']}), chose "
          f"{type(choice.node).__name__}({choice.node.block_size}, "
          f"{choice.node.num_iter}) behind "
          f"{[type(t).__name__ for t in choice.prefix]} (static: "
          f"{static_4e['chosen']}); featurize launches {launches['fused_cifar_featurize']} "
          f"({sample_fz} for the sample) against the static path's "
          f"{static_4e['featurize']}; fit {fit_s:.2f} s (static "
          f"{static_4e['fit_s']:.2f} s); test error {err:.4f} (static "
          f"{static_4e['error']:.4f})", flush=True)
    assert node["provenance"] == "sampled", node
    assert (n, d, k) == (N_TRAIN, 8 * NUM_FILTERS, 10), rule
    assert type(choice.node) is BlockLeastSquaresEstimator
    assert (choice.node.block_size, choice.node.num_iter) == (
        SOLVER_BLOCK, SOLVER_PASSES), choice.node
    assert sample_fz >= 1, node
    assert launches["fused_cifar_featurize"] - sample_fz == \
        static_4e["featurize"], (launches, static_4e)
    del fitted, pred, train_x, labels
    PipelineEnv.reset()
    _release()
    for phase, (nodes, counts, n_img) in rules.items():
        print(f"[4p] {phase}: the node rule's choices "
              f"{[(x['node'], x['chosen'], x['provenance']) for x in nodes]}"
              f"; banded_matmul {counts['banded_matmul']}, fv_moments "
              f"{counts['fv_moments']} ({n_img} images, no sample)",
              flush=True)

    # (c) check --all in process: nothing allocated, nothing launched
    _sync()
    before = torch.cuda.memory_allocated()
    kernels.reset_launches()
    report = os.path.join(workdir, "check.json")
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["check", "--all", "--json", report])
    check_s = time.time() - t0
    with open(report) as f:
        apps = json.load(f)["apps"]
    _sync()
    after = torch.cuda.memory_allocated()
    clean = sum(not a["diagnostics"] for a in apps)
    print(f"[4p] check --all: exit {rc}, {clean} of {len(apps)} apps clean "
          f"in {check_s:.2f} s; device memory allocated {before} B before, "
          f"{after} B after; launches {dict(kernels.LAUNCHES)}; "
          f"{out.getvalue().splitlines()[-4]}", flush=True)
    assert rc == 0 and len(apps) == clean == 11, (rc, len(apps), clean)
    assert after == before, (before, after)
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES

    # (d) the command line's --trace-out at the bench configuration, on the
    # surrogate written in the CIFAR binary layout the loader reads
    paths = []
    for name, x, y in (("train", tr_x, tr_y), ("test", te_x, te_y)):
        pixels = np.clip(np.rint(x), 0, 255).astype(np.uint8)
        rec = np.concatenate([y.astype(np.uint8)[:, None],
                              pixels.transpose(0, 3, 1, 2).reshape(
                                  len(x), -1)], axis=1)
        path = os.path.join(workdir, f"cifar_{name}.bin")
        rec.tofile(path)
        paths.append(path)
    trace_path = os.path.join(workdir, "cifar_trace.json")
    PipelineEnv.reset()
    kernels.reset_launches()
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(out):
        rc = cli.main(["cifar.random_patch", "--trainLocation", paths[0],
                       "--testLocation", paths[1], "--numFilters",
                       str(NUM_FILTERS), "--lambda", str(config.lam),
                       "--device", "cuda", "--trace-out", trace_path])
    trace_s = time.time() - t0
    fz_launches = kernels.LAUNCHES["fused_cifar_featurize"]
    fz_flops = kernels.WORK["fused_cifar_featurize"]["flops"]
    with open(trace_path) as f:
        nodes = json.load(f)
    annotated = [x for x in nodes["nodes"] if x["flops"] > 0]
    fz_nodes = [x for x in annotated
                if x["kernel_launches"].get("fused_cifar_featurize")]
    node_fz = sum(x["kernel_flops"] for x in fz_nodes)
    print(f"[4p] python -m keystone_tpu_torch cifar.random_patch "
          f"--trace-out ({NUM_FILTERS} filters, {N_TRAIN} / {N_TEST} images "
          f"from CIFAR binary files): exit {rc} in {trace_s:.2f} s; "
          f"featurize launched {fz_launches} times, the wrapper's work "
          f"{fz_flops / 1e9:.3f} GFLOP ({work.featurize_work(1, NUM_FILTERS)[0] / 1e9 + work.featurize_work(1, NUM_FILTERS)[1] / 1e9:.4f} "
          f"GFLOP an image), the featurize nodes' annotated kernel FLOPs "
          f"{node_fz / 1e9:.3f} GFLOP; {len(annotated)} nodes annotated, "
          f"uncovered {nodes['uncovered']}", flush=True)
    print("[4p] per-node MFU and bandwidth (H100 peaks: 989e12 FLOP/s, "
          "3350e9 B/s):", flush=True)
    for x in annotated:
        print(f"[4p]   {x['operator'][:36]:<36} #{x['node_id']:<4} self "
              f"{x['wall_s'] * 1e3:9.3f} ms  {x['flops'] / 1e9:10.3f} GFLOP"
              f" (kernel {x['kernel_flops'] / 1e9:.3f}, torch "
              f"{x['torch_flops'] / 1e9:.3f})  mfu {x['mfu']:.5f}  membw "
              f"{x['membw_util']:.5f}  {x['kernel_launches']}", flush=True)
    assert rc == 0, out.getvalue()[-2000:]
    assert fz_launches > 0 and fz_nodes, (fz_launches, annotated)
    assert node_fz == fz_flops, (node_fz, fz_flops)
    assert all(0 < x["mfu"] <= 1 for x in annotated), annotated
    del nodes
    PipelineEnv.reset()
    _release()

    # (e) numerics renders 4l's poisoned-chunk post-mortem; benchdiff on
    # the repository's artifacts exits as the JAX command does (pinned in
    # tests/test_torch_benchdiff.py)
    pm_dir = os.environ["KEYSTONE_TORCH_POSTMORTEM_DIR"]
    pms = sorted(f for f in os.listdir(pm_dir)
                 if f.startswith("postmortem-numerics_tripwire"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_num = cli.main(["numerics", os.path.join(pm_dir, pms[0])])
    text = out.getvalue()
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc_bd = cli.main(["benchdiff", os.path.join(REPO, "BENCH_r02.json"),
                          os.path.join(REPO, "BENCH_r01.json")])
    print(f"[4p] numerics {pms[0]}: exit {rc_num}, "
          f"{text.splitlines()[0]}; {[l.strip() for l in text.splitlines() if l.strip().startswith('chunk:')]}; "
          f"benchdiff BENCH_r02 -> BENCH_r01: exit {rc_bd}, "
          f"{out.getvalue().strip().splitlines()[-1]}", flush=True)
    assert rc_num == 0 and "chunk: 5" in text, text[:2000]
    assert rc_bd == 2, rc_bd
    print(f"[4p] phase 4p in {time.time() - t_phase:.1f} s", flush=True)


def _scans_gates_phase(kernels, workdir, dev, smi):
    """Phase 4q (see the module docstring): the tree-wide scans and
    ``check --all`` in process, ``check --xla`` on the card for two apps,
    and ``tools/ci.py`` with every gate on the card."""
    from keystone_tpu_torch import __main__ as cli
    from keystone_tpu_torch.analysis.concurrency import \
        scan_package as scan_concurrency
    from keystone_tpu_torch.analysis.hotpath import (HOTPATH_SCAN_BUDGET_S,
                                                     scan_package as
                                                     scan_hotpath)

    t_phase = time.time()
    pkg = os.path.join(REPO, "keystone_tpu_torch")
    # (a) each scan alone, then check --all with both in its report
    seconds = {}
    for name, scan in (("concurrency", scan_concurrency),
                       ("hotpath", scan_hotpath)):
        t0 = time.time()
        hits = scan(pkg)
        seconds[name] = time.time() - t0
        assert hits == [], (name, hits[:3])
    report = os.path.join(workdir, "check_4q.json")
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["check", "--all", "--json", report])
    check_s = time.time() - t0
    with open(report) as f:
        blob = json.load(f)
    summary = [line for line in out.getvalue().splitlines()
               if line.split(":")[0] in ("concurrency", "hotpath", "spmd",
                                          "metrics names")]
    print(f"[4q] concurrency scan {seconds['concurrency']:.2f} s, hotpath "
          f"scan {seconds['hotpath']:.2f} s (budget "
          f"{HOTPATH_SCAN_BUDGET_S:.0f} s), 0 findings each; check --all: "
          f"exit {rc} in {check_s:.2f} s, {summary}, --json keys "
          f"{sorted(blob)}; {smi}", flush=True)
    assert rc == 0 and blob["concurrency"] == [] and blob["hotpath"] == []
    assert seconds["hotpath"] < HOTPATH_SCAN_BUDGET_S, seconds

    # (b) check --xla on the card: each per-item node once on a zero item
    kernels.reset_launches()
    for app in ("cifar.random_patch", "voc.sift_fisher"):
        report = os.path.join(workdir, f"xla_{app}.json")
        t0 = time.time()
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main(["check", app, "--xla", "--device", "cuda",
                           "--json", report])
        xla_s = time.time() - t0
        with open(report) as f:
            rows = json.load(f)["xla_verify"]
        ok = [r for r in rows if r["status"] == "ok"]
        print(f"[4q] check {app} --xla on the card: exit {rc} in "
              f"{xla_s:.2f} s, {len(ok)} of {len(rows)} nodes run once and "
              "byte-checked", flush=True)
        seen = set()
        for r in ok:
            key = (r["operator"], r["plan_item_nbytes"],
                   r["device_peak_bytes"])
            if key in seen:
                continue
            seen.add(key)
            peak = r["device_peak_bytes"]
            print(f"[4q]   {r['operator']:<34} plan "
                  f"{r['plan_item_nbytes']:.0f} B/item, device out "
                  f"{r['device_output_bytes']:.0f} B, peak "
                  + ("not measured" if peak is None else
                     f"{peak:.0f} B above the run's start")
                  + f", plan_vs_device {r['plan_vs_device']}", flush=True)
        assert rc == 0 and ok, (app, rc, rows[:3])
    xla_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"[4q] check --xla kernel launches {xla_launches}", flush=True)
    assert xla_launches.get("fused_cifar_featurize", 0) >= 1, xla_launches
    assert xla_launches.get("banded_matmul", 0) >= 1, xla_launches
    _release()

    # (c) the CI chain, every gate on the card, the chaos gate at one seed
    log = os.path.join(workdir, "ci_4q.log")
    t0 = time.time()
    with open(log, "w") as f:
        proc = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch.tools.ci",
             "--device", "cuda", "--chaos-seeds", "1"], cwd=REPO,
            stdout=f, stderr=subprocess.STDOUT, timeout=900)
    ci_s = time.time() - t0
    with open(log) as f:
        text = f.read()
    keep = ("ci: ", "recompile gate: ", "numerics gate: ", "serving gate: ",
            "chaos gate: ", "fleet gate: ", "elastic gate: ")
    for line in text.splitlines():
        if line.startswith(keep) and not line.startswith("chaos gate:   "):
            print(f"[4q] {line}", flush=True)
    print(f"[4q] tools/ci.py --device cuda --chaos-seeds 1: exit "
          f"{proc.returncode} in {ci_s:.1f} s; {smi}", flush=True)
    assert proc.returncode == 0, text[-4000:]
    print(f"[4q] phase 4q in {time.time() - t_phase:.1f} s", flush=True)
    return text


def _solver_phase(kernels, rpc, tr_x, tr_y, te_x, te_y, filters, whitener,
                  config, lin_test, dev):
    """Phase 4e (see the module docstring). Returns the kernel launch
    counts of the resident fit and of the streamed fit, and the static
    choice's readings phase 4p compares the sampled path with."""
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.nodes.images.core import (
        GrayScaler,
        ImageVectorizer,
    )
    from keystone_tpu_torch.nodes.learning import (
        BlockLeastSquaresEstimator,
        DenseLBFGSwithL2,
        LeastSquaresEstimator,
        LinearMapEstimator,
    )
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
        Densify,
    )
    from keystone_tpu_torch.parallel.dataset import ArrayDataset, HostDataset
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.workflow.common import Cacher
    from keystone_tpu_torch.workflow.env import PipelineEnv

    lam = float(config.lam)
    train_x = ArrayDataset.from_numpy(tr_x, dev)
    test_x = ArrayDataset.from_numpy(te_x, dev)
    y_train = ArrayDataset.from_numpy(tr_y.astype(np.int32), dev)
    labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
              >> Cacher("labels"))(y_train)

    # -- 1. resident: the node-level rule chooses inside Pipeline.fit
    clock = _RuleClock(kernels)
    kernels.reset_launches()
    _sync()
    t0 = time.time()
    try:
        fitted = _chosen_cifar(rpc, filters, whitener, config, train_x,
                               labels).fit()
        _sync()
    finally:
        clock.close()
    fit_s = time.time() - t0
    launches = dict(kernels.LAUNCHES)
    (rule,) = [c for c in clock.choices if not c["streaming"]]
    n, d, k, density, machines = rule["args"]
    choice = rule["choice"]
    (node,) = [c for c in clock.nodes if c["node"] == "LeastSquaresEstimator"]
    print(f"[solver] resident RandomPatchCifar with LeastSquaresEstimator("
          f"lam={lam}): {node['provenance']} (n, d, k) = ({n}, {d}, {k}), "
          f"density {density:.6f}, {machines} machine; EC2 costs "
          f"{ {name: f'{c:.4g}' for name, c in rule['costs'].items()} }; "
          f"chose {type(choice.node).__name__}("
          f"{getattr(choice.node, 'block_size', '')}, "
          f"{getattr(choice.node, 'num_iter', '')}) behind "
          f"{[type(t).__name__ for t in choice.prefix]}; rule: "
          f"{clock.summary()}; fit {fit_s:.2f} s (incl. the rule); launches "
          f"{launches}", flush=True)
    assert (n, d, k, machines) == (N_TRAIN, 8 * NUM_FILTERS, 10, 1), rule
    want = LeastSquaresEstimator(lam=lam)._choose(n, d, k, density, 1)
    assert type(choice.node) is type(want.node) is BlockLeastSquaresEstimator
    assert (choice.node.block_size, choice.node.num_iter) == (
        SOLVER_BLOCK, SOLVER_PASSES), choice.node
    # the rule's default: the analyzer's shapes, no sampled execution, so
    # the featurize kernel launches for the fit alone (the sampled path is
    # driven in phase 4p)
    assert node["provenance"] == "static", node
    assert rule["shape_source"] == "static" and density == 1.0, rule
    assert node["sample_launches"] == {}, node
    assert launches["fused_cifar_featurize"] >= 1, launches
    mapper = _operator(fitted, "BlockLinearMapper")
    assert mapper.block_size == SOLVER_BLOCK
    test_pred = fitted.apply(test_x).get()
    r_test = evaluate_multiclass(test_pred, te_y, rpc.NUM_CLASSES).total_error
    print(f"[solver] resident test error {r_test:.4f} (phase 4's solver "
          f"{CIFAR_ERROR_FIRST} first reading)", flush=True)
    assert 0.02 < r_test < 0.90, r_test
    assert r_test < lin_test - 0.15, (r_test, lin_test)
    assert abs(r_test - SOLVER_ERROR_FIRST) <= SOLVER_ERROR_DRIFT, r_test
    static_4e = {"density": density, "featurize":
                 launches["fused_cifar_featurize"], "fit_s": fit_s,
                 "error": r_test,
                 "chosen": f"{type(choice.node).__name__}("
                           f"{choice.node.block_size}, "
                           f"{choice.node.num_iter})"}
    featurizer = _operator(fitted, "FusedConvRectifyPool")
    r_scaler = _operator(fitted, "StandardScalerModel")
    r_W = torch.as_tensor(mapper.weights).float()
    r_preds = test_pred.numpy()
    del fitted, test_pred

    # -- 2. each candidate on the same scaled training matrix
    X = ArrayDataset(torch.cat([r_scaler.apply_batch(featurizer.apply_batch(
        train_x.data[i:i + CHUNK])) for i in range(0, N_TRAIN, CHUNK)]),
        N_TRAIN)
    Y = labels.get()
    est = LeastSquaresEstimator(lam=lam)
    static_4e["candidate_s"], models = _candidates("CIFAR features", est, X,
                                                   Y, {
        "DenseLBFGSwithL2": DenseLBFGSwithL2(lam=lam, num_iterations=20),
        "BlockLeastSquaresEstimator": BlockLeastSquaresEstimator(
            SOLVER_BLOCK, SOLVER_PASSES, lam=lam),
        "LinearMapEstimator": LinearMapEstimator(lam=lam)})
    models["BCD(4096, 1)"] = BlockLeastSquaresEstimator(4096, 1, lam=lam).fit(
        X, Y)
    _solver_accuracy(models, X, Y, ArrayDataset(torch.cat([
        r_scaler.apply_batch(featurizer.apply_batch(test_x.data[i:i + CHUNK]))
        for i in range(0, N_TEST, CHUNK)]), N_TEST), te_y, lam)
    del X, models
    pixels = ArrayDataset((GrayScaler() >> ImageVectorizer()).apply(
        train_x).get().data, N_TRAIN)
    _candidates("LinearPixels' width", est, pixels, Y, {
        "BlockLeastSquaresEstimator": BlockLeastSquaresEstimator(
            SOLVER_BLOCK, SOLVER_PASSES, lam=lam),
        "LinearMapEstimator": LinearMapEstimator(lam=lam)})
    del pixels
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 3. sparse: Sparsify -> SparseLBFGSwithL2 through the same rule
    t0 = time.time()
    items, Ys = _sparse_dataset(SPARSE_N, SPARSE_D, SPARSE_NNZ, SEED)
    sparse_train = HostDataset(items)
    sparse_labels = ArrayDataset.from_numpy(Ys, dev)
    make_s = time.time() - t0

    def sparse_fit(lam_s):
        PipelineEnv.reset()
        clock = _RuleClock(kernels)
        try:
            fitted = LeastSquaresEstimator(lam=lam_s).with_data(
                sparse_train, sparse_labels).fit()
            _sync()
        finally:
            clock.close()
        return fitted, clock

    t0 = time.time()
    fitted_sp, clock = sparse_fit(SPARSE_LAM)
    sparse_s = time.time() - t0
    (rule,) = clock.choices
    n, d, k, density, machines = rule["args"]
    model = _operator(fitted_sp, "SparseLinearMapper")
    names = sorted(type(fitted_sp._graph.get_operator(x)).__name__
                   for x in fitted_sp._graph.nodes)
    stats = model._solve_stats
    print(f"[solver] sparse ({n}, {d}, {k}) at density {density:.6f} "
          f"(host items made in {make_s:.2f} s): EC2 costs "
          f"{ {name: f'{c:.4g}' for name, c in rule['costs'].items()} }; "
          f"rule: {clock.summary()}; fitted graph {names}; fit "
          f"{sparse_s:.2f} s (incl. the rule); L-BFGS {stats}", flush=True)
    assert type(rule["choice"].node).__name__ == "SparseLBFGSwithL2"
    assert [type(t).__name__ for t in rule["choice"].prefix] == ["Sparsify"]
    assert names.count("Sparsify") == 1 and "SparseLinearMapper" in names
    dense_x = Densify(dev).apply_dataset(sparse_train)
    dense = DenseLBFGSwithL2(lam=SPARSE_LAM, num_iterations=20).fit(
        dense_x, sparse_labels)
    gap = _rel(model.weights, dense.weights)
    exact = _ridge_float64(dense_x.data, sparse_labels.data, SPARSE_LAM)
    print(f"[solver] sparse fit against DenseLBFGSwithL2 on the densified "
          f"copy: max |delta W| / max |W_dense| {gap:.3e} (bar "
          f"{SPARSE_DENSE_TOL}); intercepts {_rel(model.intercept, dense.intercept):.3e}"
          f" apart; against the exact float64 ridge solve: sparse "
          f"{_rel(model.weights, exact):.3e}, dense "
          f"{_rel(dense.weights, exact):.3e}; dense L-BFGS "
          f"{dense._solve_stats}", flush=True)
    assert gap <= SPARSE_DENSE_TOL, gap
    again, _ = sparse_fit(SPARSE_LAM)
    W2 = _operator(again, "SparseLinearMapper")
    same = (torch.equal(W2.weights, model.weights)
            and torch.equal(W2.intercept, model.intercept))
    print(f"[solver] second sparse fit: same bits {same}", flush=True)
    assert same
    # at the CIFAR path's lam: the reference algorithm's stop
    fitted10, _ = sparse_fit(lam)
    model10 = _operator(fitted10, "SparseLinearMapper")
    dense10 = DenseLBFGSwithL2(lam=lam, num_iterations=20).fit(
        dense_x, sparse_labels)
    exact10 = _ridge_float64(dense_x.data, sparse_labels.data, lam)
    print(f"[solver] at lam = {lam}: sparse against dense "
          f"{_rel(model10.weights, dense10.weights):.3e}; against the exact "
          f"float64 solve: sparse {_rel(model10.weights, exact10):.3e} "
          f"(L-BFGS {model10._solve_stats}), dense "
          f"{_rel(dense10.weights, exact10):.3e} (L-BFGS "
          f"{dense10._solve_stats}); bar on the sparse fit "
          f"{SPARSE_HEAVY_L2_TOL}", flush=True)
    assert _rel(model10.weights, exact10) <= SPARSE_HEAVY_L2_TOL, \
        _rel(model10.weights, exact10)
    del (fitted_sp, again, fitted10, model, model10, W2, dense, dense10,
         dense_x, exact, exact10, items, sparse_train, sparse_labels)
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4. streamed: the stream's n is known, so the rule's static path
    # chooses among the one-pass solvers before the fit (as the JAX
    # package's default does)
    stream = StreamingDataset.from_numpy(
        tr_x, CHUNK, device=dev, prefetch_depth=DEPTH, tag="cifar-train")
    labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
              >> Cacher("labels"))(y_train)
    clock = _RuleClock(kernels)
    kernels.reset_launches()
    _sync()
    t0 = time.time()
    try:
        fitted_s = _chosen_cifar(rpc, filters, whitener, config, stream,
                                 labels).fit()
        _sync()
    finally:
        clock.close()
    stream_s = time.time() - t0
    stream_launches = dict(kernels.LAUNCHES)
    (final,) = clock.choices
    n_chunks = -(-N_TRAIN // CHUNK)
    s_mapper = _operator(fitted_s, "BlockLinearMapper")
    s_W = torch.as_tensor(s_mapper.weights).float()
    s_pred = fitted_s.apply(test_x).get().numpy()
    s_test = evaluate_multiclass(s_pred, te_y, rpc.NUM_CLASSES).total_error
    print(f"[solver] streamed ({n_chunks} chunks of {CHUNK}): the rule "
          f"{[(x['node'], x['provenance']) for x in clock.nodes]} chose "
          f"{type(final['choice'].node).__name__}("
          f"{final['choice'].node.block_size}, "
          f"{final['choice'].node.num_iter}) at {final['args']} among "
          f"{list(final['costs'])}; fit {stream_s:.2f} s; launches "
          f"{stream_launches}; test error {s_test:.4f} (resident "
          f"{r_test:.4f}); max |W_stream - W_resident| / max |W_resident| "
          f"{_rel(s_W, r_W):.3e}; predictions agree on "
          f"{float(np.mean(s_pred == r_preds)):.4f}", flush=True)
    assert [(x["node"], x["provenance"]) for x in clock.nodes] == [
        ("LeastSquaresEstimator", "static")], clock.nodes
    assert final["streaming"] and final["shape_source"] == "static", final
    assert type(final["choice"].node) is type(choice.node)
    assert (final["choice"].node.block_size, final["choice"].node.num_iter) \
        == (choice.node.block_size, choice.node.num_iter)
    assert stream_launches["gram_cross"] == n_chunks, stream_launches
    assert _rel(s_W, r_W) <= W_STREAM_RESIDENT_TOL
    assert abs(s_test - r_test) <= 0.01, (s_test, r_test)
    f64 = _float64_check(
        featurizer,
        {"resident": (r_scaler, r_W),
         "streamed": (_operator(fitted_s, "StandardScalerModel"), s_W)},
        tr_x, tr_y, lam, dev, block=SOLVER_BLOCK, passes=SOLVER_PASSES)
    print(f"[float64] BCD({SOLVER_BLOCK}, {SOLVER_PASSES}) max |W - W64| / "
          f"max |W64|: resident against the data-form float64 solve of its "
          f"input {f64['resident']:.3e}, streamed against the Gram-form "
          f"float64 solve of its input {f64['streamed_gram']:.3e} (data form "
          f"{f64['streamed']:.3e}); Gram form against data form, both "
          f"float64: {f64['gram_form']:.3e}", flush=True)
    assert f64["resident"] <= W_FLOAT64_TOL, f64
    assert f64["streamed_gram"] <= W_FLOAT64_TOL, f64
    assert f64["gram_form"] <= GRAM_FORM_FLOAT64_TOL, f64
    del fitted_s, stream, labels, featurizer, r_scaler
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()
    return launches, stream_launches, static_4e


def _mnist_phase(dev):
    """Phase 4f (see the module docstring). Returns its configuration and
    its host training images and labels, which phase 4t fits again."""
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_mnist
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.images.mnist import random_fft
    from keystone_tpu_torch.workflow.env import PipelineEnv

    (tx, ty), (vx, vy) = make_surrogate_mnist(MNIST_TRAIN, MNIST_TEST)
    train = LabeledData(ArrayDataset.from_numpy(tx, dev),
                        ArrayDataset.from_numpy(ty, dev))
    test = LabeledData(ArrayDataset.from_numpy(vx, dev),
                       ArrayDataset.from_numpy(vy, dev))
    config = random_fft.MnistRandomFFTConfig(
        num_ffts=MNIST_FFTS, block_size=MNIST_BLOCK, lam=MNIST_LAM, seed=SEED)
    PipelineEnv.reset()
    _sync()
    t0 = time.time()
    fitted, train_eval, test_eval = random_fft.run(config, train=train,
                                                   test=test, device=dev)
    _sync()
    run_s = time.time() - t0
    del fitted
    # the same fit and apply again, timed apart, with the fit's peak
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _sync()
    opt_fit = _OptimizerClock()
    t0 = time.time()
    try:
        fitted = random_fft.build_pipeline(config, train).fit()
        _sync()
    finally:
        opt_fit.close()
    fit_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    opt_apply = _OptimizerClock()
    t0 = time.time()
    try:
        test_pred = fitted(test.data).get()
        _sync()
    finally:
        opt_apply.close()
    apply_s = time.time() - t0
    # the fit's graph before and after the optimizer: the fit path's 600
    # branch nodes become one fused featurizer
    raw, optimized = opt_fit.first
    branch_names = ("RandomSignNode", "PaddedFFT", "LinearRectifier")
    raw_branch = sum(type(op).__name__ in branch_names
                     for op in _fit_path_ops(raw))
    opt_ops = _fit_path_ops(optimized)
    opt_branch = sum(type(op).__name__ in branch_names for op in opt_ops)
    fused = _fused_featurizers(opt_ops, MNIST_FFTS)
    print(f"[mnist] the fit path's graph: {raw_branch} branch nodes before "
          f"the optimizer, {opt_branch} after it, {len(fused)} fused "
          f"featurizer node ({len(raw.nodes)} -> {len(optimized.nodes)} "
          f"nodes in all)", flush=True)
    assert raw_branch == 3 * MNIST_FFTS, raw_branch
    assert opt_branch == 0 and len(fused) == 1, (opt_branch, len(fused))
    del raw, optimized, opt_ops, fused
    opt_fit.first = None
    train_pred = fitted(train.data).get()
    preds = test_pred.numpy()
    features = MNIST_FFTS * 512
    tr_err = evaluate_multiclass(train_pred, train.labels,
                                 random_fft.NUM_CLASSES).total_error
    te_err = evaluate_multiclass(test_pred, test.labels,
                                 random_fft.NUM_CLASSES).total_error
    print(f"[mnist] MnistRandomFFT {MNIST_FFTS} FFT branches, {features} "
          f"features, block {MNIST_BLOCK}, lam {MNIST_LAM}, {MNIST_TRAIN} / "
          f"{MNIST_TEST} surrogate images: run() {run_s:.2f} s (train error "
          f"{train_eval.total_error:.4f}, test error "
          f"{test_eval.total_error:.4f}); fit {fit_s:.2f} s ({MNIST_TRAIN / fit_s:.0f}"
          f" train img/s), test apply {apply_s:.3f} s ({MNIST_TEST / apply_s:.0f}"
          f" img/s), {(MNIST_TRAIN + MNIST_TEST) / (fit_s + apply_s):.0f} "
          f"img/s fit + apply; train error {tr_err:.4f}, test error "
          f"{te_err:.4f}; fit device-memory peak {peak / 2**30:.2f} GiB "
          f"(PR 8, without fusion: {MNIST_PEAK_UNFUSED_GIB} GiB; "
          f"{base / 2**30:.2f} GiB allocated before it)", flush=True)
    print(f"[mnist] inside the fit: {opt_fit.summary()}; inside the test "
          f"apply: {opt_apply.summary()}", flush=True)
    assert preds.shape == (MNIST_TEST,)
    assert preds.min() >= 0 and preds.max() < random_fft.NUM_CLASSES
    assert tr_err <= MNIST_TRAIN_ERROR, tr_err
    assert train_eval.total_error <= MNIST_TRAIN_ERROR, train_eval.total_error
    mapper = _operator(fitted, "BlockLinearMapper")
    W = torch.as_tensor(mapper.weights).float()
    F = random_fft.build_featurizer(config).apply(train.data).get().data
    assert F.shape == (MNIST_TRAIN, features), F.shape
    # every prediction's class scores finite, and the inputs of the bar
    ok = all(bool(torch.isfinite(t).all())
             for t in (F, W, mapper.apply_batch(F)))
    Y = torch.where(torch.arange(10, device=dev) == train.labels.data[:, None],
                    1.0, -1.0)
    bounds = [(lo, min(features, lo + MNIST_BLOCK))
              for lo in range(0, features, MNIST_BLOCK)]
    W64, _ = _bcd_float64(F, Y, MNIST_LAM, bounds, 1)
    w_rel = _rel(W, W64)
    print(f"[float64] MnistRandomFFT weights against the float64 BCD "
          f"({len(bounds)} blocks of {MNIST_BLOCK}, one pass) of the fit's "
          f"own features: max |W - W64| / max |W64| {w_rel:.3e} (bar "
          f"{MNIST_F64_TOL}); features, weights and train scores finite: "
          f"{ok}", flush=True)
    assert ok
    assert w_rel <= MNIST_F64_TOL, w_rel
    del fitted, F, W64, train, test
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()
    return config, tx, ty


def _timit_phase(dev):
    """Phase 4g (see the module docstring)."""
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_timit
    from keystone_tpu_torch.loaders.timit import (
        NUM_CLASSES,
        TimitFeaturesData,
    )
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.speech import timit

    (tx, ty), (vx, vy) = make_surrogate_timit(TIMIT_TRAIN, TIMIT_TEST)
    train = LabeledData(ArrayDataset.from_numpy(tx, dev),
                        ArrayDataset.from_numpy(ty, dev))
    test = LabeledData(ArrayDataset.from_numpy(vx, dev),
                       ArrayDataset.from_numpy(vy, dev))
    config = timit.TimitConfig(num_cosines=TIMIT_COSINES, gamma=TIMIT_GAMMA,
                               lam=TIMIT_LAM, num_epochs=TIMIT_EPOCHS)
    features = TIMIT_COSINES * config.num_cosine_features
    _release()
    _sync()
    t0 = time.time()
    fitted, run_eval = timit.run(config, TimitFeaturesData(train, test),
                                 device=dev)
    _sync()
    run_s = time.time() - t0
    del fitted
    # the same fit and apply again, timed apart, with the fit's peak
    _release()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    opt_fit = _OptimizerClock()
    t0 = time.time()
    try:
        fitted = timit.build_pipeline(config, train).fit()
        _sync()
    finally:
        opt_fit.close()
    fit_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    opt_apply = _OptimizerClock()
    t0 = time.time()
    try:
        test_pred = fitted(test.data).get()
        _sync()
    finally:
        opt_apply.close()
    apply_s = time.time() - t0
    raw, optimized = opt_fit.first
    raw_branch = sum(type(op).__name__ == "CosineRandomFeatures"
                     for op in _fit_path_ops(raw))
    fused = _fused_featurizers(_fit_path_ops(optimized), TIMIT_COSINES)
    del raw, optimized
    opt_fit.first = None
    te_err = evaluate_multiclass(test_pred, test.labels,
                                 NUM_CLASSES).total_error
    print(f"[timit] TIMIT {TIMIT_COSINES} cosine branches, {features} "
          f"features, BCD({config.num_cosine_features}, {TIMIT_EPOCHS}, "
          f"{TIMIT_LAM}), gamma {TIMIT_GAMMA:.6g}, {TIMIT_TRAIN} / "
          f"{TIMIT_TEST} surrogate frames: run() {run_s:.2f} s (test error "
          f"{run_eval.total_error:.4f}); fit {fit_s:.2f} s "
          f"({TIMIT_TRAIN / fit_s:.0f} train frames/s), test apply "
          f"{apply_s:.3f} s ({TIMIT_TEST / apply_s:.0f} frames/s), "
          f"{(TIMIT_TRAIN + TIMIT_TEST) / (fit_s + apply_s):.0f} frames/s "
          f"fit + apply; test error {te_err:.4f}; fit device-memory peak "
          f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB allocated before "
          f"it); the fit path: {raw_branch} branch nodes before the "
          f"optimizer, {len(fused)} fused featurizer node after it",
          flush=True)
    print(f"[timit] inside the fit: {opt_fit.summary()}; inside the test "
          f"apply: {opt_apply.summary()}", flush=True)
    assert raw_branch == TIMIT_COSINES and len(fused) == 1, \
        (raw_branch, len(fused))
    lo, hi = TIMIT_ERROR_BAND
    assert lo < te_err < hi, te_err
    mapper = _operator(fitted, "BlockLinearMapper")
    W = torch.as_tensor(mapper.weights).float()
    del fitted, test_pred
    _release()
    F = timit.build_featurizer(config).apply(train.data).get().data
    assert F.shape == (TIMIT_TRAIN, features), F.shape
    ok = all(bool(torch.isfinite(t).all())
             for t in (F, W, mapper.apply_batch(F[:4096])))
    Y = torch.where(torch.arange(NUM_CLASSES, device=dev)
                    == train.labels.data[:, None], 1.0, -1.0)
    block = config.num_cosine_features
    bounds = [(b, min(features, b + block))
              for b in range(0, features, block)]
    t0 = time.time()
    W64, P64 = _bcd_float64(F, Y, TIMIT_LAM, bounds, TIMIT_EPOCHS)
    f64_s = time.time() - t0
    # the same BCD written out in float32: what a plain float32 solve of
    # these features reaches
    W32, P32 = _bcd_float64(F, Y, TIMIT_LAM, bounds, TIMIT_EPOCHS,
                            dtype=torch.float32)
    del P32
    P = torch.cat([mapper.apply_batch(F[i:i + 4096])
                   for i in range(0, TIMIT_TRAIN, 4096)]) - torch.as_tensor(
        mapper.intercept, device=dev)
    w_rel, w_plain = _rel(W, W64), _rel(W32, W64)
    p_rel = _rel(P, P64)
    print(f"[float64] TIMIT against the float64 BCD ({len(bounds)} blocks "
          f"of {block}, {TIMIT_EPOCHS} passes, block by block, {f64_s:.1f} "
          f"s) of the fit's own features: weights max |W - W64| / max |W64| "
          f"{w_rel:.3e}, the plain float32 BCD's {w_plain:.3e} (bar "
          f"{TIMIT_F64_RATIO}x it); training scores max |P - P64| / max "
          f"|P64| {p_rel:.3e} (bar {TIMIT_SCORE_TOL}); features, weights and "
          f"scores finite: {ok}", flush=True)
    assert ok
    assert w_rel <= TIMIT_F64_RATIO * w_plain, (w_rel, w_plain)
    assert p_rel <= TIMIT_SCORE_TOL, p_rel
    del F, W, W64, P64, W32, P, Y, mapper, train, test
    _release()


def _random_cifar_phase(tr_x, tr_y, te_x, te_y, lin_test, dev):
    """Phase 4h (see the module docstring)."""
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
    )
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.images.cifar import random_cifar
    from keystone_tpu_torch.workflow.env import PipelineEnv
    from keystone_tpu_torch.workflow.optimizer.default import NoOpOptimizer

    config = random_cifar.RandomCifarConfig(seed=SEED)
    train = LabeledData(ArrayDataset.from_numpy(tr_x, dev),
                        ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))
    test = LabeledData(ArrayDataset.from_numpy(te_x, dev),
                       ArrayDataset.from_numpy(te_y.astype(np.int32), dev))
    _release()
    _sync()
    t0 = time.time()
    fitted, train_eval, test_eval = random_cifar.run(config, train, test,
                                                     device=dev)
    _sync()
    run_s = time.time() - t0
    del fitted
    preds, seconds, labels = {}, {}, {}
    for name, opt in (("default", None), ("no-op", NoOpOptimizer())):
        _release()
        if opt is not None:
            PipelineEnv.get_or_create().set_optimizer(opt)
        clock = _OptimizerClock()
        try:
            t0 = time.time()
            train_labels = ClassLabelIndicatorsFromIntLabels(
                random_cifar.NUM_CLASSES)(train.labels)
            fitted = random_cifar.build_pipeline(config, train.data,
                                                 train_labels).fit()
            _sync()
            fit_s = time.time() - t0
            t0 = time.time()
            out = fitted(test.data).get()
            _sync()
            seconds[name] = (fit_s, time.time() - t0)
        finally:
            clock.close()
        preds[name] = out.numpy()
        _, optimized = clock.first
        labels[name] = [op.label() for op in _fit_path_ops(optimized)]
        del fitted, out, optimized, clock
    _release()
    featurizer = ("Fused[Convolver >> SymmetricRectifier >> Pooler >> "
                  "ImageVectorizer]")
    te_err = test_eval.total_error
    agree = float(np.mean(preds["default"] == preds["no-op"]))
    print(f"[random-cifar] RandomCifar {config.num_filters} filters, patch "
          f"{config.patch_size}, pool {config.pool_size} / "
          f"{config.pool_stride}, {config.num_filters * 8} features, exact "
          f"solve, {N_TRAIN} / {N_TEST} surrogate images: run() {run_s:.2f} "
          f"s, train error {train_eval.total_error:.4f}, test error "
          f"{te_err:.4f} (LinearPixels {lin_test:.4f}); DefaultOptimizer fit "
          f"{seconds['default'][0]:.2f} s, test apply "
          f"{seconds['default'][1]:.3f} s; NoOpOptimizer fit "
          f"{seconds['no-op'][0]:.2f} s, test apply "
          f"{seconds['no-op'][1]:.3f} s; predictions of the two fits agree "
          f"on {agree:.4f} of test images; the fit path under the "
          f"DefaultOptimizer: {labels['default']}", flush=True)
    lo, hi = RC_ERROR_BAND
    assert lo < te_err < hi, te_err
    assert labels["default"].count(featurizer) == 1, labels["default"]
    assert featurizer not in labels["no-op"], labels["no-op"]
    assert np.array_equal(preds["default"], preds["no-op"]), agree
    return te_err


def _auto_cache_phase(kernels, rpc, tr_x, tr_y, te_x, filters, whitener,
                      config, dev):
    """Phase 4i (see the module docstring). Returns the featurize kernel's
    launches in the fit under each optimizer."""
    from keystone_tpu_torch.nodes.learning import BlockLeastSquaresEstimator
    from keystone_tpu_torch.nodes.images.core import FusedConvRectifyPool
    from keystone_tpu_torch.nodes.stats import StandardScaler
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
        MaxClassifier,
    )
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.workflow.env import PipelineEnv
    from keystone_tpu_torch.workflow.optimizer import auto_cache
    from keystone_tpu_torch.workflow.optimizer.default import (
        AutoCachingOptimizer,
    )

    train = ArrayDataset.from_numpy(tr_x, dev)
    test = ArrayDataset.from_numpy(te_x, dev)
    seen = {}
    real = {name: getattr(auto_cache, name) for name in
            ("profile_graph", "_device_mem_budget", "make_cached_graph")}

    # the fit's optimize is the first to call each; the apply's optimize
    # profiles and plans its own graph after it
    def profile_graph(graph, *args):
        out = real["profile_graph"](graph, *args)
        seen.setdefault("profiles", (graph, out))
        return out

    def budget(device=None):
        out = real["_device_mem_budget"](device)
        seen.setdefault("budget", (out, torch.cuda.mem_get_info(dev)[0]))
        return out

    def make_cached_graph(graph, to_cache):
        seen.setdefault("cached", sorted(
            f"{graph.get_operator(n).label()} (node {n.id})"
            for n in to_cache))
        return real["make_cached_graph"](graph, to_cache)

    preds, launches, seconds = {}, {}, {}
    for name, opt in (("default", None), ("auto-cache", AutoCachingOptimizer())):
        _release()
        if opt is not None:
            PipelineEnv.get_or_create().set_optimizer(opt)
            auto_cache.profile_graph = profile_graph
            auto_cache._device_mem_budget = budget
            auto_cache.make_cached_graph = make_cached_graph
        try:
            # RandomPatchCifar as a user writes it with no hints: no Cacher
            labels = ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)(
                ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))
            pipe = FusedConvRectifyPool(
                filters, rpc.IMAGE_SIZE, config.patch_size, rpc.NUM_CHANNELS,
                config.pool_stride, config.pool_size, config.alpha,
                whitener=whitener,
            ).and_then(StandardScaler(), train).and_then(
                BlockLeastSquaresEstimator(BLOCK, PASSES, config.lam), train,
                labels) >> MaxClassifier()
            kernels.reset_launches()
            _sync()
            t0 = time.time()
            fitted = pipe.fit()
            _sync()
            fit_s = time.time() - t0
            launches[name] = kernels.LAUNCHES["fused_cifar_featurize"]
            t0 = time.time()
            out = fitted(test).get()
            _sync()
            seconds[name] = (fit_s, time.time() - t0)
            preds[name] = out.numpy()
        finally:
            for attr, fn in real.items():
                setattr(auto_cache, attr, fn)
        del fitted, out, pipe, labels
    _release()
    graph, profiles = seen["profiles"]
    shown = ", ".join(
        f"{graph.get_operator(n).label()} (node {n.id}): {p.ns / 1e9:.4f} s, "
        f"{p.mem / 2**20:.1f} MiB" for n, p in sorted(
            profiles.items(), key=lambda kv: kv[0].id))
    budget_b, free_b = seen["budget"]
    print(f"[auto-cache] RandomPatchCifar without Cachers ({NUM_FILTERS} "
          f"filters, BCD({BLOCK}, {PASSES})), greedy AutoCachingOptimizer: "
          f"budget {budget_b / 2**30:.3f} GiB read from the card (free "
          f"{free_b / 2**30:.3f} GiB when read); profiles extrapolated to "
          f"{N_TRAIN} images from samples of 2 and 4: {shown}; cached "
          f"{seen['cached']}; fused_cifar_featurize launches in the fit: "
          f"DefaultOptimizer {launches['default']}, AutoCachingOptimizer "
          f"{launches['auto-cache']}; fit / test apply seconds: "
          f"DefaultOptimizer {seconds['default'][0]:.2f} / "
          f"{seconds['default'][1]:.3f}, AutoCachingOptimizer "
          f"{seconds['auto-cache'][0]:.2f} / {seconds['auto-cache'][1]:.3f}",
          flush=True)
    assert abs(budget_b - 0.75 * free_b) <= AUTO_CACHE_BUDGET_SLACK, \
        (budget_b, free_b)
    assert np.array_equal(preds["default"], preds["auto-cache"])
    assert launches["default"] > 0 and launches["auto-cache"] > 0, launches
    return launches


def _imagenet_stage_timer(timed):
    """A _StageTimer on phase 4j's stages: SIFT, LCS, the PCA fits, the
    GMM fits (k-means++ + EM), the Fisher vectors and the weighted
    solve."""
    from keystone_tpu_torch.nodes.images.extractors import (
        LCSExtractor,
        SIFTExtractor,
    )
    from keystone_tpu_torch.nodes.images.fisher_vector import FisherVector
    from keystone_tpu_torch.nodes.learning import gmm as gmm_mod
    from keystone_tpu_torch.nodes.learning.block_weighted import (
        BlockWeightedLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.pca import (
        DistributedColumnPCAEstimator,
        LocalColumnPCAEstimator,
    )

    timer = _StageTimer(timed)
    timer.wrap(SIFTExtractor, "apply", "SIFT")
    timer.wrap(LCSExtractor, "apply", "LCS")
    timer.wrap(DistributedColumnPCAEstimator, "_fit", "PCA fits")
    timer.wrap(LocalColumnPCAEstimator, "_fit", "PCA fits")
    timer.wrap(gmm_mod.GaussianMixtureModelEstimator, "fit_matrix",
               "GMM fits")
    timer.wrap(FisherVector, "apply", "FV")
    timer.wrap(BlockWeightedLeastSquaresEstimator, "_solve", "solve")
    return timer


class _Recorder:
    """Keeps the arguments of calls to a class's method (the card's
    tensors, by reference), and each call's object and result, while
    ``on``; ``close`` removes the wrapper. Made before a _StageTimer
    wraps the same method, it is closed after it."""

    def __init__(self, owner, attr):
        self.owner, self.attr = owner, attr
        self.real = getattr(owner, attr)
        self.calls, self.results, self.on = [], [], True
        real = self.real

        def wrapped(obj, *args, **kwargs):
            out = real(obj, *args, **kwargs)
            if self.on:
                self.calls.append(args)
                self.results.append((obj, out))
            return out

        setattr(owner, attr, wrapped)

    def close(self):
        setattr(self.owner, self.attr, self.real)


def _imagenet_fit_apply(inet, config, train, test, dev, timer):
    """One ImageNetSiftLcsFV fit on ``train`` and top-k apply on ``test``
    from a clean prefix memo, with ``timer``'s wrappers in place. Returns
    the fitted predictor, the test top-k (n, k), the fit and apply
    seconds and the stage calls of the fit."""
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
    )
    from keystone_tpu_torch.parallel.dataset import ArrayDataset

    from keystone_tpu_torch.workflow.env import PipelineEnv

    PipelineEnv.reset()
    try:
        _sync()
        t0 = time.time()
        labels = ClassLabelIndicatorsFromIntLabels(INET_CLASSES)\
            .apply_dataset(ArrayDataset.from_numpy(np.asarray(
                [it.label for it in train.collect()], np.int64), dev))
        fitted = inet.build_pipeline(config, inet.images_on(train, dev),
                                     labels, INET_TOP_K).fit()
        _sync()
        fit_s = time.time() - t0
        fit_calls = dict(timer.calls)
        t0 = time.time()
        top = torch.stack(fitted(inet.images_on(test, dev)).get().collect())
        _sync()
        apply_s = time.time() - t0
    finally:
        timer.close()
    return fitted, top, fit_s, apply_s, fit_calls


def _top_k_error(top, labels):
    return float(1.0 - np.any(top == labels[:, None], axis=1).mean())


def _imagenet_phase(kernels, workdir, dev):
    """Phase 4j (see the module docstring), with 4n(c) on its fitted
    predictor. Returns the kernel launch counts of the main pass's fit +
    apply and of 4n(c)'s apply, and 4n(c)'s seconds."""
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_imagenet
    from keystone_tpu_torch.nodes.learning.block_weighted import (
        BlockWeightedLeastSquaresEstimator,
    )
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
    from keystone_tpu_torch.pipelines.images.imagenet import (
        sift_lcs_fv as inet,
    )

    t0 = time.time()
    train, test = make_surrogate_imagenet(INET_TRAIN, INET_TEST, seed=SEED,
                                          num_classes=INET_CLASSES, h=INET_H,
                                          w=INET_W)
    test_labels = np.array([it.label for it in test.collect()])
    print(f"[imagenet] surrogate ImageNet: {INET_TRAIN} train / {INET_TEST} "
          f"test uint8 images at {INET_H}x{INET_W}x3 over {INET_CLASSES} "
          f"classes made "
          f"in {time.time() - t0:.1f} s", flush=True)
    config = inet.ImageNetSiftLcsFVConfig()

    # the main pass: stage calls counted, nothing synchronized inside; the
    # solver's inputs and the test features kept for the float64 solve
    # (the recorders wrap first, so the stage timer, closed first, leaves
    # them in place)
    solves = _Recorder(BlockWeightedLeastSquaresEstimator, "_solve")
    applies = _Recorder(BlockLinearMapper, "apply")
    counter = _imagenet_stage_timer(timed=False)
    rule = _RuleClock(kernels)
    _sync()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        fitted, top, fit_s, apply_s, fit_calls = _imagenet_fit_apply(
            inet, config, train, test, dev, counter)
    finally:
        rule.close()
        solves.close()
        applies.close()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    top = top.cpu().numpy()
    err = _top_k_error(top, test_labels)
    rand = np.random.RandomState(SEED).randn(INET_TEST, INET_CLASSES)
    rand_top = np.argsort(-rand, axis=1)[:, :INET_TOP_K]
    rand_err = _top_k_error(rand_top, test_labels)
    model = _operator(fitted, "BlockLinearMapper")
    stats = model._solve_stats
    sift_apps, lcs_apps, fv_apps = (counter.calls[k]
                                    for k in ("SIFT", "LCS", "FV"))
    n_img = INET_TRAIN + INET_TEST
    print(f"[imagenet] ImageNetSiftLcsFV desc_dim {config.desc_dim}, vocab "
          f"{config.vocab_size}, SIFT scale_step {config.sift_scale_step}, "
          f"LCS stride {config.lcs_stride} border {config.lcs_border} patch "
          f"{config.lcs_patch}, {config.num_pca_samples} PCA / "
          f"{config.num_gmm_samples} GMM samples, "
          f"{4 * config.desc_dim * config.vocab_size} features, "
          f"BlockWeightedLeastSquares({config.block_size}, 1, {config.lam}, "
          f"{config.mixture_weight}) over {INET_CLASSES} classes, no stage "
          f"timers: fit {fit_s:.2f} s ({INET_TRAIN / fit_s:.1f} train img/s), "
          f"apply {apply_s:.2f} s ({INET_TEST / apply_s:.1f} test img/s), "
          f"{n_img / (fit_s + apply_s):.1f} img/s overall; fit + apply "
          f"device-memory peak {peak / 2**30:.2f} GiB", flush=True)
    print(f"[imagenet] node-level rule (seconds inside the fit): "
          f"{rule.summary()}", flush=True)
    print(f"[imagenet] solver {stats}; SIFT applications {sift_apps} "
          f"({fit_calls['SIFT']} in the fit), LCS {lcs_apps} "
          f"({fit_calls['LCS']}), FV {fv_apps}; launches {launches}",
          flush=True)
    print(f"[imagenet] test top-{INET_TOP_K} error {err:.4f} (seeded random "
          f"scores {rand_err:.4f})", flush=True)
    print(f"[4p] 4j device-memory peak {peak / 2**30:.2f} GiB (PR 10, "
          f"with the sampled values: 64.72 GiB)", flush=True)
    assert top.shape == (INET_TEST, INET_TOP_K)
    assert {n["provenance"] for n in rule.nodes} == {"static"}, rule.nodes
    assert sift_apps == lcs_apps == n_img, (sift_apps, lcs_apps)
    RULE_RECORDS["4j"] = (rule.nodes, launches, n_img)
    assert launches["banded_matmul"] == 10 * sift_apps, (launches, sift_apps)
    assert launches["fv_moments"] == fv_apps == 2 * n_img, (launches, fv_apps)
    assert stats["solver"] == "woodbury", stats
    assert err < rand_err - INET_RANDOM_MARGIN, (err, rand_err)

    # the same solver in float64 on the same features
    (X, L, n, *_), = solves.calls
    F_test = torch.stack([args[0] for args in applies.calls])
    assert F_test.shape[0] == INET_TEST, F_test.shape
    est = BlockWeightedLeastSquaresEstimator(
        config.block_size, 1, config.lam, config.mixture_weight)
    m64 = est._solve(X.double(), L.double(), n)
    W32, W64 = model.weights.to(torch.float64), m64.weights
    w_err = float((W32 - W64).abs().max() / W64.abs().max())
    scores64 = F_test.double() @ W64 + m64.intercept
    top64 = torch.sort(scores64, dim=1, descending=True,
                       stable=True).indices[:, :INET_TOP_K].cpu().numpy()
    agree = float(np.mean([set(a) == set(b) for a, b in zip(top, top64)]))
    scores32 = F_test @ model.weights + model.intercept
    s_err = float((scores32.double() - scores64).abs().max()
                  / scores64.abs().max())
    print(f"[imagenet] against the same solver in float64 on the fit's "
          f"features ({tuple(X.shape)}): weights max |delta| / max "
          f"{w_err:.3e}, test scores {s_err:.3e}, top-{INET_TOP_K} sets "
          f"agree on {agree:.4f} of test images; float64 solver "
          f"{m64._solve_stats}", flush=True)
    del X, L, F_test, m64, W32, W64, scores64, scores32, solves, applies
    assert agree >= INET_TOP_AGREE, agree
    assert w_err <= INET_F64_TOL, w_err
    del model
    # 4n(c): the same test images from tar archives through the loader
    t0 = time.time()
    tar_launches = _imagenet_tar_check(kernels, inet, fitted, test, top,
                                       err, rand_err, workdir, dev)
    tar_s = time.time() - t0
    del fitted
    _release()

    # a second, instrumented pass for the per-stage split
    timer = _imagenet_stage_timer(timed=True)
    fitted, _, t_fit_s, t_apply_s, _ = _imagenet_fit_apply(
        inet, config, train, test, dev, timer)
    stages = ", ".join(f"{k} {v:.3f} s ({timer.calls[k]} calls)"
                       for k, v in timer.seconds.items())
    print(f"[imagenet] instrumented pass (the card synchronized around every "
          f"stage call): fit {t_fit_s:.2f} s, apply {t_apply_s:.2f} s; "
          f"seconds per stage: {stages}", flush=True)
    del fitted
    _release()
    return launches, tar_launches, tar_s


def _weighted_rehearsal(dev):
    """The weighted solve at the rehearsal shape (see the module
    docstring): "woodbury" and "cholesky" on the same data, each in
    float32 and in float64."""
    from keystone_tpu_torch.nodes.learning.block_weighted import (
        BlockWeightedLeastSquaresEstimator,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    X = torch.randn((REHEARSAL_N, REHEARSAL_D), generator=gen, device=dev)
    y = torch.as_tensor(np.random.RandomState(SEED).randint(
        0, INET_CLASSES, REHEARSAL_N), device=dev)
    L = torch.where(torch.arange(INET_CLASSES, device=dev) == y[:, None],
                    1.0, -1.0)
    fits, seconds, peaks = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        for solver in ("woodbury", "cholesky"):
            _release()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            est = BlockWeightedLeastSquaresEstimator(
                REHEARSAL_D, 1, INET_LAM, INET_MIXTURE, solver=solver)
            key = (solver, str(dtype).split(".")[1])
            _sync()
            t0 = time.time()
            fits[key] = est.fit_arrays(X.to(dtype), L.to(dtype))
            _sync()
            seconds[key] = time.time() - t0
            peaks[key] = torch.cuda.max_memory_allocated() - base

    def w(key):
        return fits[key].weights.double()

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    ref = ("cholesky", "float64")
    Xd = X.double()
    ref_scores = Xd @ w(ref) + fits[ref].intercept.double()
    counts = np.bincount(y.cpu().numpy(), minlength=INET_CLASSES)
    print(f"[rehearsal] BlockWeightedLeastSquares({REHEARSAL_D}, 1, "
          f"{INET_LAM}, {INET_MIXTURE}) on seeded randn X ({REHEARSAL_N}, "
          f"{REHEARSAL_D}), {INET_CLASSES} classes drawn at random (largest "
          f"class {counts.max()}, {int((counts == 0).sum())} empty): "
          + "; ".join(f"{s} {d} {seconds[(s, d)]:.2f} s, peak above the "
                      f"inputs {peaks[(s, d)] / 2**30:.2f} GiB, class chunk "
                      f"{fits[(s, d)]._solve_stats['class_chunk']} "
                      f"({fits[(s, d)]._solve_stats['chunks']} chunks)"
                      for s, d in fits), flush=True)
    out = {"f32": rel(w(("woodbury", "float32")), w(("cholesky", "float32"))),
           "f64": rel(w(("woodbury", "float64")), w(ref))}
    agree = {}
    for s in ("woodbury", "cholesky"):
        out[s] = rel(w((s, "float32")), w((s, "float64")))
        scores = Xd @ w((s, "float32")) + fits[(s, "float32")].intercept
        out[s + " scores"] = rel(scores, ref_scores)
        agree[s] = float((scores.argmax(1) == ref_scores.argmax(1))
                         .double().mean())
    print(f"[rehearsal] woodbury against cholesky, max |delta| / max: float32 "
          f"{out['f32']:.3e}, float64 {out['f64']:.3e}; each float32 path "
          f"against its float64 solve: woodbury {out['woodbury']:.3e}, "
          f"cholesky {out['cholesky']:.3e}; float32 training scores against "
          f"the float64 solve's: woodbury {out['woodbury scores']:.3e} "
          f"(argmax agreement {agree['woodbury']:.4f}), cholesky "
          f"{out['cholesky scores']:.3e} ({agree['cholesky']:.4f})",
          flush=True)
    assert all(bool(torch.isfinite(m.weights).all()) for m in fits.values())
    assert out["f64"] <= REHEARSAL_F64_TOL, out
    for s in ("woodbury", "cholesky"):
        assert out[s + " scores"] <= REHEARSAL_SCORE_TOL, out
        assert agree[s] >= REHEARSAL_ARGMAX_AGREE, agree
    del X, L, fits, Xd, ref_scores
    _release()


def _augmented_phase(tr_x, tr_y, te_x, te_y, rc_err, dev):
    """Phase 4k (see the module docstring)."""
    from keystone_tpu_torch.evaluation.augmented import evaluate_augmented
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.images.cifar import (
        random_patch_cifar_augmented as aug,
    )

    config = aug.AugmentedConfig(seed=SEED)
    train = LabeledData(
        ArrayDataset.from_numpy(tr_x[:AUG_TRAIN], dev),
        ArrayDataset.from_numpy(tr_y[:AUG_TRAIN].astype(np.int32), dev))
    test = ArrayDataset.from_numpy(te_x, dev)
    _release()
    torch.cuda.reset_peak_memory_stats()
    _sync()
    t0 = time.time()
    filters, whitener = aug.learn_filters(train.data, config)
    images, labels = aug.augment_train(config, train)
    fitted = aug.build_pipeline(config, filters, whitener, images,
                                labels).fit()
    _sync()
    fit_s = time.time() - t0
    fit_peak = torch.cuda.max_memory_allocated()
    t0 = time.time()
    patches, ids = aug.augment_test(test)
    scores = fitted(patches).get()
    _sync()
    apply_s = time.time() - t0
    n_aug = patches.n // test.n
    ev = evaluate_augmented(ids, scores, np.repeat(te_y, n_aug),
                            aug.NUM_CLASSES)
    err = ev.total_error
    print(f"[augmented] RandomPatchCifarAugmented {config.num_filters} "
          f"filters, patch {config.patch_size}, pool {config.pool_size} / "
          f"{config.pool_stride}, alpha {config.alpha}, lam {config.lam}, "
          f"{config.num_random_patches_augment} random 24x24 patches an "
          f"image and flips at 0.5 on {AUG_TRAIN} training images "
          f"({images.n} patches), {n_aug} test patches an image on "
          f"{test.n}: fit {fit_s:.2f} s ({images.n / fit_s:.0f} patches/s), "
          f"fit peak {fit_peak / 2**30:.2f} GiB, apply {apply_s:.2f} s "
          f"({patches.n / apply_s:.0f} patches/s); test error {err:.4f} "
          f"(RandomCifar, phase 4h: {rc_err:.4f})", flush=True)
    lo, hi = AUG_ERROR_BAND
    assert scores.n == patches.n and bool(torch.isfinite(scores.data).all())
    assert lo < err < hi, err
    del fitted, images, labels, patches, scores, train, test
    _release()


def _check_imagenet_kernels(kernels, sift, dev):
    """Phase 3 at ImageNetSiftLcsFV's shapes: every two-sided contraction
    of one 480 x 640 image at scale_step 1 and fv_moments at (64, 16) at
    both branches' descriptor counts, each against its plain version
    and twice for the same bits. Returns the largest absolute errors
    (banded, FV)."""
    from keystone_tpu_torch.nodes.learning.gmm import _posteriors

    banded = 0.0
    for i, (band, X, right) in enumerate(_banded_image_calls(
            kernels, sift, dev, (INET_H, INET_W), scale_step=1)):
        got = kernels.banded_matmul(band, X, right=right)
        again = kernels.banded_matmul(band, X, right=right)
        want = kernels.banded_matmul_plain(band, X, right=right)
        _sync()
        assert torch.equal(got, again) and bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"[check] banded_matmul 480x640 scale_step 1 call {i} "
              f"{band.shape} x {tuple(X.shape)} x {right.shape}: max abs "
              f"err {err:.3e} (rel {err / scale:.3e})", flush=True)
        assert err <= BANDED_TOL * scale, (i, err, scale)
        banded = max(banded, err)
    fv = 0.0
    for n in INET_FV_N:
        X, means, variances, weights = _fv_inputs(
            np.random.RandomState(n), 64, 16, n, dev)
        q64 = _posteriors(X.T.double(), means.T.double(),
                          variances.T.double(), weights.double(), 0.0)
        clear = ((q64.log() - np.log(1e-4)).abs() > FV_CLEAR).all(dim=1)
        del q64
        Xc = X[:, clear].contiguous()
        terms = kernels.fv_terms(means, variances, weights)
        got = kernels.fv_moments(Xc, means, variances, weights, 1e-4,
                                 terms=terms)
        again = kernels.fv_moments(Xc, means, variances, weights, 1e-4,
                                   terms=terms)
        want = kernels.fv_moments_plain(Xc, means, variances, weights, 1e-4)
        _sync()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        errs = []
        for name, g, w in zip(("s0", "s1", "s2"), got, want):
            assert bool(torch.isfinite(g).all())
            err = float((g - w).abs().max())
            scale = float(w.abs().max())
            errs.append(f"{name} {err:.3e} (rel {err / scale:.3e})")
            assert err <= FV_TOL * scale, (n, name, err, scale)
            fv = max(fv, err)
        print(f"[check] fv_moments D=64 K=16 n={n} ({Xc.shape[1]} "
              f"descriptors clear of the threshold): max abs err "
              f"{', '.join(errs)}", flush=True)
    return banded, fv


def _time_imagenet_kernels(kernels, sift, dev):
    """Phase 5 at ImageNetSiftLcsFV's shapes: one 480 x 640 image's 10
    banded calls (scale_step 1) and fv_moments at (64, 16, n) for both
    branches' n, each one call at a time and from a CUDA graph, beside
    the plain version, two dense / addmm products and the bound. Returns
    a dict for the kernels line."""
    from keystone_tpu_torch.nodes.learning.gmm import _posteriors
    from keystone_tpu_torch.tools import device_ms as _device_ms

    out = {}
    calls = _banded_image_calls(kernels, sift, dev, (INET_H, INET_W),
                                scale_step=1)
    dense = [(torch.as_tensor(band, device=dev),
              torch.as_tensor(right, device=dev).T)
             for band, _, right in calls]

    def each(fn):
        return lambda: [fn(i, band, X, right)
                        for i, (band, X, right) in enumerate(calls)]

    fns = {
        "kernel": each(lambda i, band, X, right: kernels.banded_matmul(
            band, X, right=right)),
        "plain": each(lambda i, band, X, right: kernels.banded_matmul_plain(
            band, X, right=right)),
        "library": each(lambda i, band, X, right: torch.matmul(
            torch.matmul(dense[i][0], X), dense[i][1])),
    }
    call = {name: _time_ms(fn, reps=20) for name, fn in fns.items()}
    devt = {name: _device_ms(fn) for name, fn in fns.items()}
    ops, nbytes = _banded_work(calls)
    bound_ms, bound_by = _bound(ops, nbytes)
    out["banded_matmul"] = {
        "shape": "one 480x640 image's 10 two-sided calls, scale_step 1",
        "ms": call["kernel"], "device_ms": devt["kernel"],
        "plain_ms": call["plain"], "plain_device_ms": devt["plain"],
        "library_ms": call["library"],
        "library_device_ms": devt["library"],
        "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"[time] banded_matmul, one 480x640 image's {len(calls)} two-sided "
          f"calls at scale_step 1: one call at a time kernel "
          f"{call['kernel']:.4f} ms, plain {call['plain']:.4f} ms, "
          f"torch.matmul dense x2 {call['library']:.4f} ms; device time "
          f"alone (CUDA graph): kernel {devt['kernel']:.4f} ms, plain "
          f"{devt['plain']:.4f} ms, torch.matmul {devt['library']:.4f} ms; "
          f"bound {bound_ms:.4f} ms by {bound_by} ({ops / 1e9:.3f} GFLOP of "
          f"band work, {nbytes / 1e6:.1f} MB)", flush=True)
    del calls, dense, fns

    D, K = 64, 16
    for n in INET_FV_N:
        X, means, variances, weights = _fv_inputs(
            np.random.RandomState(n), D, K, n, dev)
        terms = kernels.fv_terms(means, variances, weights)
        XX = torch.cat([X * X, X]).T.contiguous()
        AB = torch.cat([0.5 / variances, -means / variances]).contiguous()
        Xm = torch.cat([X, X * X]).contiguous()
        post = _posteriors(X.T, means.T, variances.T, weights,
                           1e-4).contiguous()
        c0 = torch.zeros(K, device=dev)
        s0 = torch.zeros(2 * D, K, device=dev)
        fns = {
            "kernel": lambda: kernels.fv_moments(X, means, variances,
                                                 weights, 1e-4, terms=terms),
            "plain": lambda: kernels.fv_moments_plain(X, means, variances,
                                                      weights, 1e-4),
            "library": lambda: (torch.addmm(c0, XX, AB),
                                torch.addmm(s0, Xm, post)),
        }
        call = {name: _time_ms(fn, reps=20) for name, fn in fns.items()}
        devt = {name: _device_ms(fn) for name, fn in fns.items()}
        ops, nbytes = _fv_work(D, K, n)
        ops *= 3  # 3xTF32: each product three times at the TF32 peak
        bound_ms, bound_by = _bound(ops, nbytes, PEAK_TF32_FLOPS)
        out[f"fv_moments n={n}"] = {
            "shape": f"(D, K, n) = ({D}, {K}, {n})",
            "ms": call["kernel"], "device_ms": devt["kernel"],
            "plain_ms": call["plain"], "plain_device_ms": devt["plain"],
            "library_ms": call["library"],
            "library_device_ms": devt["library"],
            "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"[time] fv_moments D={D} K={K} n={n}: one call at a time "
              f"kernel {call['kernel']:.4f} ms, plain {call['plain']:.4f} "
              f"ms, torch.addmm x2 (both GEMMs) {call['library']:.4f} ms; "
              f"device time alone (CUDA graph): kernel "
              f"{devt['kernel']:.4f} ms, plain {devt['plain']:.4f} ms, "
              f"torch.addmm x2 {devt['library']:.4f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} (3xTF32: {ops / 1e9:.3f} "
              f"GFLOP at the TF32 peak, {nbytes / 1e6:.2f} MB)", flush=True)
        del X, means, variances, weights, terms, XX, AB, Xm, post, fns
    return out


def _banded_image_calls(kernels, sift, dev, shape=(375, 500),
                        scale_step=0):
    """The 10 banded_matmul calls of one SIFT image (375 x 500 at
    VOCSIFTFisher's scale_step 0 by default), as (band, X, right) triples
    recorded from ``dense_sift`` on a seeded image."""
    calls = []
    real = sift.banded_matmul

    def record(band, X, right=None):
        calls.append((band, (X if X.dim() == 3 else X[None]).clone(),
                      right))
        return real(band, X, right=right)

    sift.banded_matmul = record
    try:
        img = torch.as_tensor(np.random.RandomState(SEED).rand(*shape)
                              .astype(np.float32), device=dev)
        sift.dense_sift(img, 4, 6, 5, scale_step)
    finally:
        sift.banded_matmul = real
    _sync()
    assert len(calls) == 10, len(calls)
    return calls




def _profile(label, fn):
    """Run ``fn`` once under torch.profiler (``--profile`` only): device
    time by kernel, and the device's idle share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _sync()
        t0 = time.time()
        fn()
        _sync()
        wall = time.time() - t0
    busy = sum(e.device_time for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e6
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=15, max_name_column_width=60))
    print(f"[profile] {label} {wall:.3f} s wall, device busy "
          f"{busy:.3f} s, idle share {1 - busy / wall:.3f}", flush=True)


def _profile_main_path(rpc, config, train, test, train_labels):
    """Fit + apply once more under torch.profiler (``--profile`` only):
    device time by kernel, and the device's idle share of the wall."""
    from keystone_tpu_torch.workflow.env import PipelineEnv

    def run():
        filters, whitener = rpc.learn_filters(train.data, config)
        fitted = rpc.build_pipeline(filters, whitener, config, train.data,
                                    train_labels).fit()
        fitted.apply(test.data).get()

    PipelineEnv.reset()  # else the prefix memo serves the earlier fit
    _profile("fit + apply", run)


def main() -> int:
    # -- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        return _main(workdir)


def _main(workdir: str) -> int:
    from keystone_tpu_torch import native
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.loaders.surrogate import make_surrogate_cifar
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
    )
    from keystone_tpu_torch.nodes.learning.gmm import _posteriors
    from keystone_tpu_torch.ops import kernels, sift
    from keystone_tpu_torch.ops.image_ops import pool_regions
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.pipelines.images.cifar import (
        linear_pixels,
        random_patch_cifar as rpc,
    )
    from keystone_tpu_torch.tools import device_ms as _device_ms
    from keystone_tpu_torch.utils.checkpoint import save_pipeline
    from keystone_tpu_torch.workflow.common import Cacher
    from keystone_tpu_torch.workflow.env import PipelineEnv

    dev = torch.device("cuda")
    torch.manual_seed(SEED)
    # post-mortems (phase 4l provokes three) stay in the run's directory
    os.environ["KEYSTONE_TORCH_POSTMORTEM_DIR"] = os.path.join(
        workdir, "postmortems")
    # the shipped weights for every choice this run asserts: a calibration
    # artifact in the checkout (phase 4s's tool writes one) is not read
    os.environ["KEYSTONE_TORCH_COST_CALIBRATION"] = os.path.join(
        workdir, "no-calibration", "cost_model_calibration.json")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    import PIL  # the tar loaders decode with Pillow (phase 4n)

    print(f"[device] {torch.cuda.get_device_name(0)} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | Pillow "
          f"{PIL.__version__} | {smi}", flush=True)

    # -- 2. build -----------------------------------------------------------
    # the native host shim (g++) alongside the kernel libraries (nvcc)
    t0 = time.time()
    with ThreadPoolExecutor(1) as pool:
        shim = pool.submit(native.build)
        logs = kernels.build_kernels()
        kernels_s = time.time() - t0
        shim_path = shim.result()
    print(f"[build] {len(kernels.SOURCES)} kernel libraries in "
          f"{kernels_s:.1f} s; the native host shim "
          f"{os.path.relpath(shim_path, REPO)} in {time.time() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        regs = [int(w) for line in log.splitlines() if "registers" in line
                for w, nxt in zip(line.split(), line.split()[1:])
                if nxt == "registers,"]
        spills = [int(line.split()[4]) for line in log.splitlines()
                  if "spill stores" in line]
        print(f"[build] {name}: {len(regs)} kernel instantiations, at most "
              f"{max(regs, default=0)} registers, {sum(spills)} bytes of "
              "spill stores", flush=True)

    # -- 3. kernel against plain --------------------------------------------
    # the main path's shapes (fit featurize, test featurize, datum path)
    # plus a ragged K; the plain version runs in chunks of 512 images, its
    # (B, 27, 27, K) intermediates being too large for 20480 at once
    rng = np.random.RandomState(SEED)
    worst = 0.0
    for B, K in ((256, NUM_FILTERS), (256, 100), (1, NUM_FILTERS),
                 (N_TEST, NUM_FILTERS), (N_TRAIN, NUM_FILTERS)):
        imgs, filters, means = _featurize_inputs(rng, B, K, dev)
        got = kernels.fused_cifar_featurize(imgs, filters,
                                            whitener_means=means)
        want = torch.cat([kernels.fused_cifar_featurize_plain(
            imgs[i:i + 512], filters, whitener_means=means)
            for i in range(0, B, 512)])
        _sync()
        assert got.shape == want.shape == (B, 4 * 2 * K), got.shape
        assert bool(torch.isfinite(got).all())
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rel = float(((got - want).abs()
                     / want.abs().clamp_min(1e-3 * scale)).max())
        print(f"[check] fused_cifar_featurize B={B} K={K}: max abs err "
              f"{err:.3e} (max |plain| {scale:.3e}), max rel err {rel:.3e}",
              flush=True)
        assert err <= FEATURIZE_TOL * scale, (err, scale)
        worst = max(worst, err)
        del imgs, filters, means, got, want
    # against float64 at the main path's geometry
    imgs, filters, means = _featurize_inputs(rng, FEATURIZE_F64_B,
                                             NUM_FILTERS, dev)
    want64 = kernels.fused_cifar_featurize_plain(
        imgs.double(), filters.double(), whitener_means=means.double())
    scale64 = float(want64.abs().max())
    k_err = float((kernels.fused_cifar_featurize(
        imgs, filters, whitener_means=means).double() - want64).abs().max())
    p_err = float((kernels.fused_cifar_featurize_plain(
        imgs, filters, whitener_means=means).double() - want64).abs().max())
    print(f"[check] fused_cifar_featurize B={FEATURIZE_F64_B} "
          f"K={NUM_FILTERS} against float64: kernel (3xTF32) "
          f"{k_err / scale64:.3e}, plain float32 {p_err / scale64:.3e} of "
          f"the largest feature", flush=True)
    assert k_err <= FEATURIZE_F64_RATIO * p_err, (k_err, p_err)
    del imgs, filters, means, want64
    # the geometries the kernel takes beyond the main path's: 9, 16 and
    # 36 pooling regions, patch size 9 on one channel, four channels
    for S, C, stride, size in FEATURIZE_GEOMETRIES:
        imgs, filters, means = _featurize_inputs(rng, 64, 200, dev, S, C)
        kw = dict(patch_size=S, channels=C, pool_stride=stride,
                  pool_size=size, whitener_means=means)
        got = kernels.fused_cifar_featurize(imgs, filters, **kw)
        want = kernels.fused_cifar_featurize_plain(imgs, filters, **kw)
        _sync()
        R = got.shape[1] // 400
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        print(f"[check] fused_cifar_featurize S={S} C={C} pool {stride}/"
              f"{size} (R={R}) B=64 K=200: max abs err {err:.3e} (max "
              f"|plain| {scale:.3e})", flush=True)
        assert got.shape == want.shape and bool(torch.isfinite(got).all())
        assert err <= FEATURIZE_TOL * scale, (S, C, stride, err, scale)
        worst = max(worst, err)
        del imgs, filters, means, got, want
    torch.cuda.empty_cache()
    gram_worst = _check_gram(kernels, rng, dev)
    quant_worst = _check_quant(kernels, rng, dev)
    banded_worst = _check_banded(kernels, sift, rng, dev)
    fv_worst = _check_fv(kernels, rng, dev)
    inet_banded_worst, inet_fv_worst = _check_imagenet_kernels(kernels, sift,
                                                               dev)
    banded_worst = max(banded_worst, inet_banded_worst)
    fv_worst = max(fv_worst, inet_fv_worst)
    _check_nan(kernels, sift, dev)

    # -- 4. main path ---------------------------------------------------------
    (tr_x, tr_y), (te_x, te_y) = make_surrogate_cifar(N_TRAIN, N_TEST,
                                                      seed=SEED)
    train = LabeledData(ArrayDataset.from_numpy(tr_x, dev),
                        ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))
    test = LabeledData(ArrayDataset.from_numpy(te_x, dev),
                       ArrayDataset.from_numpy(te_y.astype(np.int32), dev))
    config = rpc.RandomCifarConfig(num_filters=NUM_FILTERS, lam=10.0,
                                   seed=SEED)

    kernels.reset_launches()
    _sync()
    torch.cuda.reset_peak_memory_stats()
    base_resident = torch.cuda.memory_allocated()
    t0 = time.time()
    train_labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
                    >> Cacher("labels"))(train.labels)
    filters, whitener = rpc.learn_filters(train.data, config)
    probe = _PlanProbe()
    try:
        fitted = rpc.build_pipeline(filters, whitener, config, train.data,
                                    train_labels).fit()
    finally:
        probe.close()
    _sync()
    fit_s = time.time() - t0
    peak_resident = torch.cuda.max_memory_allocated()
    t0 = time.time()
    test_pred = fitted.apply(test.data).get()
    _sync()
    apply_s = time.time() - t0
    train_pred = fitted.apply(train.data).get()
    datum = [fitted.apply_datum(test.data.data[i]).get() for i in range(8)]
    _sync()
    launches = dict(kernels.LAUNCHES)

    preds = test_pred.numpy()
    assert preds.shape == (N_TEST,) and preds.min() >= 0 \
        and preds.max() < rpc.NUM_CLASSES
    datum = np.array([int(d) for d in datum])
    assert np.array_equal(datum, preds[:8]), (datum, preds[:8])
    rp_train = evaluate_multiclass(train_pred, train.labels,
                                   rpc.NUM_CLASSES).total_error
    rp_test = evaluate_multiclass(test_pred, test.labels,
                                  rpc.NUM_CLASSES).total_error
    print(f"[e2e] RandomPatchCifar {NUM_FILTERS} filters, "
          f"{filters.shape[0] * 8} features: fit {fit_s:.2f} s "
          f"({N_TRAIN / fit_s:.0f} img/s incl. filter learning), apply "
          f"{apply_s:.3f} s ({N_TEST / apply_s:.0f} img/s), train error "
          f"{rp_train:.4f}, test error {rp_test:.4f}, launches {launches}",
          flush=True)
    _, _, lin_eval = linear_pixels.run(
        linear_pixels.LinearPixelsConfig(lam=10.0), train, test, device=dev)
    lin_test = lin_eval.total_error
    print(f"[e2e] LinearPixels test error {lin_test:.4f}", flush=True)
    assert 0.02 < rp_test < 0.90, rp_test
    assert 0.30 < lin_test < 0.98, lin_test
    assert rp_test < lin_test - 0.15, (rp_test, lin_test)
    assert abs(rp_test - CIFAR_ERROR_FIRST) <= CIFAR_ERROR_DRIFT, rp_test
    assert launches["fused_cifar_featurize"] > 0, \
        "fused_cifar_featurize was not launched on the main path"
    _plan_line("phase 4 (resident CIFAR fit)", *probe.plan("4"))
    if "--profile" in sys.argv[1:]:
        _profile_main_path(rpc, config, train, test, train_labels)
    resident_W = torch.as_tensor(
        _operator(fitted, "BlockLinearMapper").weights).float()
    resident_scaler = _operator(fitted, "StandardScalerModel")
    featurizer = _operator(fitted, "FusedConvRectifyPool")
    # phase 4t evaluates this model
    mapper_4 = _operator(fitted, "BlockLinearMapper")
    model_path = os.path.join(workdir, "rpc.pkl")
    save_pipeline(fitted, model_path)
    del fitted, train, train_labels, test_pred, train_pred

    # -- 4b. streamed path ----------------------------------------------------
    # the prefix memo pins the resident fit's features; the streamed fit
    # starts from a clean memo with only the test set on the device
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()
    chunk_bytes = CHUNK * 32 * 32 * 3 * 4          # an f32 image chunk
    budget = (DEPTH + 1) * chunk_bytes + (1 << 20)
    stream = StreamingDataset.from_numpy(
        tr_x, CHUNK, device=dev, prefetch_depth=DEPTH, tag="cifar-train",
        hbm_budget=budget)
    labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
              >> Cacher("labels"))(
        ArrayDataset.from_numpy(tr_y.astype(np.int32), dev))

    def streamed_fit():
        return rpc.build_pipeline(filters, whitener, config, stream,
                                  labels).fit()

    kernels.reset_launches()
    _sync()
    torch.cuda.reset_peak_memory_stats()
    base_stream = torch.cuda.memory_allocated()
    t0 = time.time()
    probe = _PlanProbe()
    try:
        fitted_s = streamed_fit()
    finally:
        probe.close()
    _sync()
    stream_s = time.time() - t0
    peak_stream = torch.cuda.max_memory_allocated()
    stream_launches = dict(kernels.LAUNCHES)
    n_chunks = -(-N_TRAIN // CHUNK)
    print(f"[stream] RandomPatchCifar streamed fit ({n_chunks} chunks of "
          f"{CHUNK}, depth {DEPTH}, two passes): {stream_s:.3f} s "
          f"({N_TRAIN / stream_s:.0f} train img/s), launches "
          f"{stream_launches}", flush=True)
    assert stream_launches["gram_cross"] == n_chunks, stream_launches
    assert stream_launches["fused_cifar_featurize"] == 2 * n_chunks, \
        stream_launches
    print(f"[stream] residency peak {stream.peak_device_nbytes:.0f} B, "
          f"static plan {stream.static_plan_nbytes():.0f} B, budget "
          f"{budget:.0f} B", flush=True)
    assert stream.peak_device_nbytes <= budget
    assert stream.buffered_nbytes() == 0.0
    plan_4b = probe.plan("4b")
    _plan_line("phase 4b (streamed CIFAR fit)", *plan_4b)
    # the raw graph holds the stream once for each fit that reads it
    # (CSE merges them when the fit optimizes)
    charges = {e["node_id"]: e["out_nbytes"] for e in plan_4b[0].entries
               if e["note"] == "stream residency bound"}
    print(f"[4p] 4b's stream in the plan: {charges} B at its nodes; "
          f"StreamingDataset.static_plan_nbytes "
          f"{stream.static_plan_nbytes():.0f} B; budget {budget:.0f} B",
          flush=True)
    assert charges and set(charges.values()) == {
        stream.static_plan_nbytes()}, charges
    assert stream.static_plan_nbytes() <= budget, budget
    print(f"[mem] device-memory peak: resident fit {peak_resident / 2**20:.1f}"
          f" MiB ({base_resident / 2**20:.1f} MiB allocated before it: "
          f"train and test images, labels), streamed fit "
          f"{peak_stream / 2**20:.1f} MiB ({base_stream / 2**20:.1f} MiB "
          "allocated before it: test images, labels)", flush=True)

    test_stream = StreamingDataset.from_numpy(te_x, CHUNK, device=dev,
                                              prefetch_depth=DEPTH)
    out = fitted_s.apply(test_stream).get()
    chunk_preds = np.concatenate([c.data[:c.n].cpu().numpy()
                                  for c in out.chunks()])
    s_pred = fitted_s.apply(test.data).get()
    s_preds = s_pred.numpy()
    s_datum = np.array([int(fitted_s.apply_datum(test.data.data[i]).get())
                        for i in range(8)])
    assert chunk_preds.shape == s_preds.shape == (N_TEST,)
    assert np.mean(chunk_preds == s_preds) >= 0.999, \
        np.mean(chunk_preds == s_preds)
    assert np.array_equal(s_datum, s_preds[:8]), (s_datum, s_preds[:8])
    s_test = evaluate_multiclass(s_pred, test.labels,
                                 rpc.NUM_CLASSES).total_error
    agree = float(np.mean(s_preds == preds))
    stream_W = torch.as_tensor(
        _operator(fitted_s, "BlockLinearMapper").weights).float()
    scaler_4b = _operator(fitted_s, "StandardScalerModel")
    w_rel = float((stream_W - resident_W).abs().max()
                  / resident_W.abs().max())
    print(f"[stream] test error {s_test:.4f} (resident {rp_test:.4f}), "
          f"predictions agree with the resident fit on {agree:.4f} of "
          f"test images, max |W_stream - W_resident| / max |W_resident| "
          f"{w_rel:.3e}", flush=True)
    assert 0.02 < s_test < 0.90, s_test
    assert s_test < lin_test - 0.15, (s_test, lin_test)
    assert agree >= 0.99, agree
    assert abs(s_test - rp_test) <= 0.01, (s_test, rp_test)
    assert w_rel <= W_STREAM_RESIDENT_TOL, w_rel
    f64 = _float64_check(
        featurizer,
        {"resident": (resident_scaler, resident_W),
         "streamed": (_operator(fitted_s, "StandardScalerModel"), stream_W)},
        tr_x, tr_y, float(config.lam), dev)
    print(f"[float64] max |W - W64| / max |W64| against the float64 BCD of "
          f"each fit's own input: resident {f64['resident']:.3e}, streamed "
          f"{f64['streamed']:.3e}; the two inputs' float64 solves differ by "
          f"{f64['inputs']:.3e}; Gram-form against data-form BCD, both "
          f"float64: {f64['gram_form']:.3e}", flush=True)
    assert f64["gram_form"] <= GRAM_FORM_FLOAT64_TOL, f64
    assert f64["resident"] <= W_FLOAT64_TOL, f64
    assert f64["streamed"] <= W_FLOAT64_TOL, f64
    assert f64["streamed"] <= W_STREAMED_F64_RATIO * W_STREAMED_F64_FLOAT32, \
        f64
    # the Gram kernel on what the streamed solver pass feeds it: the first
    # chunk, featurized and scaled, with its +-1 labels, into the carry
    # the second chunk leaves
    scaler_s = _operator(fitted_s, "StandardScalerModel")
    Xc, Yc = [], []
    for lo in (0, CHUNK):
        Xc.append(scaler_s.apply_batch(featurizer.apply_batch(
            torch.as_tensor(tr_x[lo:lo + CHUNK], device=dev))))
        Yc.append(torch.where(torch.arange(10, device=dev) == torch.as_tensor(
            tr_y[lo:lo + CHUNK], device=dev)[:, None], 1.0, -1.0))
    G0 = Xc[1].double().T @ Xc[1].double()
    G0 = ((G0 + G0.T) / 2).float()
    C0 = (Xc[1].double().T @ Yc[1].double()).float()
    _gram_float64(kernels, Xc[0], Yc[0], G0, C0, "first featurized chunk")
    del Xc, Yc, G0, C0, scaler_s
    if "--profile" in sys.argv[1:]:
        PipelineEnv.reset()
        _profile("streamed fit", streamed_fit)
    ref_4b = {"W": stream_W, "mean": scaler_4b.mean, "std": scaler_4b.std}
    del fitted_s, out, stream, test_stream, labels, test
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4l. resilience and telemetry on the streamed fit ---------------------
    resilience_gram = _resilience_phase(
        kernels, rpc, tr_x, tr_y, filters, whitener, config, featurizer,
        ref_4b, workdir, dev, smi)
    del ref_4b
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4c. serving ----------------------------------------------------------
    opt_serve = _OptimizerClock()
    try:
        serve_launches = _serving_phase(kernels, model_path, te_x, te_y,
                                        preds, dev)
    finally:
        opt_serve.close()
    print(f"[serve] inside the serving phase: {opt_serve.summary()}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4m. the serving fleet ----------------------------------------------
    t0 = time.time()
    fleet_launches = _fleet_phase(kernels, model_path, te_x, te_y, preds,
                                  dev, smi)
    print(f"[fleet] phase 4m in {time.time() - t0:.1f} s; the replicas' "
          f"launches in the traffic window: served (graph replays x the "
          f"launches each capture recorded) {fleet_launches['replayed']}, "
          f"the re-admission's eager ones {fleet_launches['eager']}",
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()

    # -- 4d. VOCSIFTFisher ----------------------------------------------------
    probe = _PlanProbe()
    try:
        voc_launches, voc_ref = _voc_phase(kernels, dev)
    finally:
        probe.close()
    _plan_line("phase 4d (VOCSIFTFisher fit)", *probe.plan("4d"))

    # -- 4n. the loaders: VOC from tars, the streamed tar path, HOG, DAISY
    # and the approximate PCA (4n(c) runs inside 4j, 4n(d) after 4f) ---------
    t0 = time.time()
    voc_tar_launches = _voc_tar_phase(kernels, voc_ref, voc_launches, workdir,
                                      dev)
    stream_tar_launches = _tar_stream_phase(kernels, workdir, dev)
    _image_nodes_phase(
        np.rint(voc_ref[1].collect()[0].image).astype(np.float32), dev)
    del voc_ref
    _release()
    loader_s = time.time() - t0

    # -- 4e. the cost-model solver choice --------------------------------------
    solver_launches, solver_stream_launches, static_4e = _solver_phase(
        kernels, rpc, tr_x, tr_y, te_x, te_y, filters, whitener, config,
        lin_test, dev)

    # -- 4f. MnistRandomFFT ---------------------------------------------------
    kernels.reset_launches()
    probe = _PlanProbe()
    try:
        mnist_4f = _mnist_phase(dev)
    finally:
        probe.close()
    # the phase's second fit, which it times and whose peak it resets for
    _plan_line("phase 4f (MnistRandomFFT fit)", *probe.plan("4f", -1))
    mnist_launches = dict(kernels.LAUNCHES)
    print(f"[mnist] kernel launches {mnist_launches} (the path runs none of "
          "the five)", flush=True)

    # -- 4n(d). MnistRandomFFT from CSV -----------------------------------------
    t0 = time.time()
    _mnist_csv_phase(workdir)
    loader_s += time.time() - t0

    # -- 4g. TIMIT --------------------------------------------------------------
    kernels.reset_launches()
    _timit_phase(dev)
    print(f"[timit] kernel launches {dict(kernels.LAUNCHES)} (the path runs "
          "none of the five)", flush=True)

    # -- 4h. RandomCifar --------------------------------------------------------
    kernels.reset_launches()
    rc_err = _random_cifar_phase(tr_x, tr_y, te_x, te_y, lin_test, dev)
    print(f"[random-cifar] kernel launches {dict(kernels.LAUNCHES)} (the "
          "path runs none of the five)", flush=True)

    # -- 4i. auto-caching ---------------------------------------------------------
    cache_launches = _auto_cache_phase(kernels, rpc, tr_x, tr_y, te_x,
                                       filters, whitener, config, dev)

    # -- 4j. ImageNetSiftLcsFV, and the weighted solve at the rehearsal shape
    inet_launches, inet_tar_launches, inet_tar_s = _imagenet_phase(
        kernels, workdir, dev)
    loader_s += inet_tar_s
    print(f"[loaders] phase 4n took {loader_s:.1f} s in all", flush=True)
    kernels.reset_launches()
    _weighted_rehearsal(dev)
    print(f"[rehearsal] kernel launches {dict(kernels.LAUNCHES)} (the solve "
          "runs none of the five)", flush=True)

    # -- 4k. RandomPatchCifarAugmented ----------------------------------------
    kernels.reset_launches()
    _augmented_phase(tr_x, tr_y, te_x, te_y, rc_err, dev)
    print(f"[augmented] kernel launches {dict(kernels.LAUNCHES)} (the path "
          "runs none of the five)", flush=True)

    # -- 4p. the analyzer: the rule's static path and its opt-out, the plan,
    # check, the traced run's MFU, numerics and benchdiff ----------------------
    _analysis_phase(kernels, rpc, tr_x, tr_y, te_x, te_y, filters, whitener,
                    config, static_4e, RULE_RECORDS, workdir, dev)
    _release()

    # -- 4o. the text and NLP apps --------------------------------------------
    _text_phase(kernels, workdir, dev, smi)

    # -- 4q. the tree-wide scans, check --xla and the CI gates ---------------------
    ci_log = _scans_gates_phase(kernels, workdir, dev, smi)

    # -- 4r. the multi-process world ---------------------------------------------
    world_launches = _world_phase(
        kernels, rpc, tr_x, tr_y, te_x, filters, whitener, config, preds,
        rp_test, resident_W, stream_W, model_path, ci_log, workdir, dev, smi)

    # -- 4s. the measurement and calibration tools ----------------------------
    tools_launches = _tools_phase(kernels, static_4e, workdir, dev, smi)

    # -- 4t. the members completing the JAX surface: the objectives, the
    # per-block evaluation and the optimizer's rule log -------------------------
    api_launches = _api_phase(kernels, mapper_4, featurizer, resident_scaler,
                              tr_x, tr_y, te_x, te_y, float(config.lam),
                              rp_test, mnist_4f, dev, smi)
    del mapper_4, featurizer, mnist_4f

    # -- 5. timing ------------------------------------------------------------
    B = K = 1024
    imgs, filters, means = _featurize_inputs(rng, B, K, dev)
    # the path's call: the bank's plan made once, as the node's
    # apply_params makes it
    fplan = kernels.featurize_plan(filters, means)
    x = imgs.permute(0, 3, 1, 2).contiguous()
    w = filters.reshape(K, 6, 6, 3).permute(0, 3, 1, 2).contiguous()
    fz_fns = {
        "kernel": lambda: kernels.fused_cifar_featurize(imgs, fplan),
        # library yardstick: the raw filter-bank product alone, as one
        # cuDNN float32 convolution (TF32 off); no single PyTorch call
        # computes the whole fused function
        "library": lambda: torch.nn.functional.conv2d(x, w),
    }
    ms, library_ms = (_time_ms(fz_fns[name], reps=20)
                      for name in ("kernel", "library"))
    fz_dev = {name: _device_ms(fn, reps=5) for name, fn in fz_fns.items()}
    plain_ms = _time_ms(lambda: kernels.fused_cifar_featurize_plain(
        imgs, filters, whitener_means=means), reps=5, warmup=1)
    ops, bound_ms, bound_by = _featurize_bound(B, K)
    host = _host_us(fz_fns["kernel"], reps=5)
    print(f"[time] fused_cifar_featurize B={B} K={K}: kernel {ms:.3f} ms, "
          f"plain {plain_ms:.3f} ms, conv2d (GEMM only) {library_ms:.3f} ms; "
          f"device time alone (CUDA graph): kernel {fz_dev['kernel']:.3f} ms, "
          f"conv2d {fz_dev['library']:.3f} ms; bound {bound_ms:.3f} ms by "
          f"{bound_by} (3xTF32 product at the TF32 peak, the rest at the "
          f"float32 peak; {ops / 1e9:.1f} GFLOP), "
          f"{ops / fz_dev['kernel'] / 1e9:.1f} TFLOP/s achieved; wrapper "
          f"host time {host:.1f} us a call", flush=True)
    # the widened path: 16 regions (pool stride 7, size 8)
    r16_ms = _time_ms(lambda: kernels.fused_cifar_featurize(
        imgs, fplan, pool_stride=7, pool_size=8), reps=10)
    span = sum(hi - lo for lo, hi in pool_regions(27, 7, 8))
    _, r16_bound, _ = _featurize_bound(B, K, R=16, region_hits=span ** 2)
    print(f"[time] fused_cifar_featurize B={B} K={K}, 16 regions (pool "
          f"stride 7, size 8): kernel {r16_ms:.3f} ms, bound "
          f"{r16_bound:.3f} ms", flush=True)
    del imgs, filters, means, x, w, fplan, fz_fns

    n, d, k = CHUNK, NUM_FILTERS * 8, 10
    X = torch.randn((n, d), device=dev)
    Y = torch.randn((n, k), device=dev)
    G = torch.zeros((d, d), device=dev)
    C = torch.zeros((d, k), device=dev)
    g_fns = {
        "kernel": lambda: kernels.gram_cross(X, Y, G, C),
        # library yardstick: the two cuBLAS float32 products (TF32 off),
        # the full square of X^T X; the port never calls them on the path
        "library": lambda: (torch.addmm(G, X.T, X), torch.addmm(C, X.T, Y)),
    }
    g_ms, g_library_ms = (_time_ms(g_fns[name], reps=20)
                          for name in ("kernel", "library"))
    g_dev = {name: _device_ms(fn) for name, fn in g_fns.items()}
    g_plain_ms = _time_ms(lambda: kernels.gram_cross_plain(X, Y, G, C),
                          reps=20)
    g_ops, g_bound_ms, g_bound_by = _gram_bound(n, d, k)
    g_host = _host_us(g_fns["kernel"], reps=10)
    print(f"[time] gram_cross n={n} d={d} k={k}: one call at a time kernel "
          f"{g_ms:.3f} ms, plain {g_plain_ms:.3f} ms, torch.addmm x2 "
          f"{g_library_ms:.3f} ms; device time alone (CUDA graph): kernel "
          f"{g_dev['kernel']:.4f} ms, torch.addmm x2 "
          f"{g_dev['library']:.4f} ms; bound {g_bound_ms:.4f} ms by "
          f"{g_bound_by} (3xTF32: {g_ops / 1e9:.1f} GFLOP triangle x 3 at "
          f"the TF32 peak, {_gram_work(n, d, k)[1] / 1e6:.1f} MB), "
          f"{100 * g_bound_ms / g_dev['kernel']:.1f}% of the bound achieved, "
          f"{g_ops / g_dev['kernel'] / 1e9:.1f} float32 TFLOP/s; wrapper "
          f"host time {g_host:.1f} us a call", flush=True)

    q_times = {}
    for n in (SERVE_MAX_BATCH, N_TEST):
        for wd, itemsize in (("bf16", 2), ("int8", 1)):
            args = _quant_inputs(rng, n, NUM_FILTERS * 8, 10, wd, dev)
            X, Wq, scale, mean, inv, b = args
            # the path's call: the model's plan made once, as the mapper's
            # apply_params makes it
            plan = kernels.quant_plan(*args[1:])
            # library yardstick: the GEMM alone, one cuBLAS float32 addmm
            # on operands normalized and dequantized outside the timing
            Xn = ((X - mean) * inv).contiguous()
            Wdeq = (Wq.to(torch.float32) * scale[None, :]).contiguous()
            fns = {"kernel": lambda: kernels.quantized_affine(X, plan),
                   "library": lambda: torch.addmm(b, Xn, Wdeq),
                   # what one plain pass over X takes: the practical floor
                   "read": lambda: X.sum()}
            t = {f"{name}_ms": _time_ms(fn, reps=50)
                 for name, fn in fns.items()}
            t.update({f"{name}_device_ms": _device_ms(fn, reps=20)
                      for name, fn in fns.items()})
            t["ms"] = t.pop("kernel_ms")
            t["device_ms"] = t.pop("kernel_device_ms")
            t["plain_ms"] = _time_ms(
                lambda: kernels.quantized_affine_plain(*args), reps=50)
            t["host_us"] = _host_us(fns["kernel"])
            q_ops, q_bytes = _quant_work(n, NUM_FILTERS * 8, 10, itemsize)
            t["bound_ms"], t["bound_by"] = _bound(q_ops, q_bytes)
            q_times[(n, wd)] = t
            print(f"[time] quantized_affine {wd} n={n} d={NUM_FILTERS * 8} "
                  f"k=10 ({plan.split(n)[0]} splits of d): one call at a "
                  f"time kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
                  f"ms, torch.addmm (GEMM only) {t['library_ms']:.4f} ms, "
                  f"X.sum (one read of X) {t['read_ms']:.4f} ms; device time "
                  f"alone (CUDA graph): kernel {t['device_ms']:.4f} ms, "
                  f"torch.addmm {t['library_device_ms']:.4f} ms, X.sum "
                  f"{t['read_device_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms "
                  f"by {t['bound_by']} ({q_ops / 1e6:.1f} MFLOP, "
                  f"{q_bytes / 1e6:.2f} MB), {q_bytes / t['device_ms'] / 1e6:.1f}"
                  f" GB/s achieved; wrapper host time {t['host_us']:.1f} us a "
                  "call", flush=True)
            del args, X, Wq, Xn, Wdeq, plan, fns
    q = q_times[(SERVE_MAX_BATCH, "bf16")]

    calls = _banded_image_calls(kernels, sift, dev)
    dense = [(torch.as_tensor(band, device=dev),
              torch.as_tensor(right, device=dev).T) for band, _, right in calls]

    def each(fn):
        return lambda: [fn(i, band, X, right)
                        for i, (band, X, right) in enumerate(calls)]

    b_fns = {
        "kernel": each(lambda i, band, X, right: kernels.banded_matmul(
            band, X, right=right)),
        "plain": each(lambda i, band, X, right: kernels.banded_matmul_plain(
            band, X, right=right)),
        # library yardstick: the same contractions as dense cuBLAS float32
        # matmuls (TF32 off), which the port never calls on the path
        "library": each(lambda i, band, X, right: torch.matmul(
            torch.matmul(dense[i][0], X), dense[i][1])),
    }
    b_call = {name: _time_ms(fn, reps=20) for name, fn in b_fns.items()}
    b_dev = {name: _device_ms(fn) for name, fn in b_fns.items()}
    b_ms, b_plain_ms, b_library_ms = (b_call[k] for k in
                                      ("kernel", "plain", "library"))
    b_ops, b_bytes = _banded_work(calls)
    b_bound_ms, b_bound_by = _bound(b_ops, b_bytes)
    b_host = _host_us(lambda: kernels.banded_matmul(*calls[1][:2],
                                                    right=calls[1][2]))
    print(f"[time] banded_matmul, one 375x500 image's {len(calls)} two-sided "
          f"calls: one call at a time kernel {b_ms:.4f} ms, plain "
          f"{b_plain_ms:.4f} ms, torch.matmul dense x2 {b_library_ms:.4f} "
          f"ms; device time alone (CUDA graph): kernel {b_dev['kernel']:.4f}"
          f" ms, plain {b_dev['plain']:.4f} ms, torch.matmul "
          f"{b_dev['library']:.4f} ms; bound {b_bound_ms:.4f} ms by "
          f"{b_bound_by} ({b_ops / 1e9:.3f} GFLOP of band work, "
          f"{b_bytes / 1e6:.1f} MB of X read and output written), "
          f"{b_bytes / b_dev['kernel'] / 1e6:.1f} GB/s achieved; wrapper "
          f"host time {b_host:.1f} us a call", flush=True)
    img = calls[0][1][0]
    s_ms = _time_ms(lambda: sift.dense_sift(img), reps=10)
    s_plain_ms = _time_ms(lambda: sift.dense_sift_plain(img), reps=10)
    print(f"[time] dense_sift of one 375x500 image: {s_ms:.3f} ms "
          f"(einsum form, plain: {s_plain_ms:.3f} ms)", flush=True)
    del calls, dense, b_fns, img

    D, K, n = 80, 256, 47213
    X, means, variances, weights = _fv_inputs(rng, D, K, n, dev)
    terms = kernels.fv_terms(means, variances, weights)
    # library yardstick of the same work: both GEMMs as cuBLAS float32
    # addmm (TF32 off), the llh product [X^2; X]^T [A; -B] and the moment
    # product [X; X^2] q, on a posterior matrix materialized outside the
    # timing
    XX = torch.cat([X * X, X]).T.contiguous()
    AB = torch.cat([0.5 / variances, -means / variances]).contiguous()
    Xm = torch.cat([X, X * X]).contiguous()
    post = _posteriors(X.T, means.T, variances.T, weights, 1e-4).contiguous()
    c0 = torch.zeros(K, device=dev)
    s0 = torch.zeros(2 * D, K, device=dev)
    f_fns = {
        "kernel": lambda: kernels.fv_moments(X, means, variances, weights,
                                             1e-4, terms=terms),
        "plain": lambda: kernels.fv_moments_plain(X, means, variances,
                                                  weights, 1e-4),
        "library": lambda: (torch.addmm(c0, XX, AB),
                            torch.addmm(s0, Xm, post)),
    }
    f_call = {name: _time_ms(fn, reps=20) for name, fn in f_fns.items()}
    f_dev = {name: _device_ms(fn) for name, fn in f_fns.items()}
    f_ms, f_plain_ms, f_library_ms = (f_call[k] for k in
                                      ("kernel", "plain", "library"))
    # 3xTF32: each of the two products (4 n D K operations each) three
    # times at the TF32 tensor-core peak
    f_ops, f_bytes = _fv_work(D, K, n)
    f_ops *= 3
    f_bound_ms, f_bound_by = _bound(f_ops, f_bytes, PEAK_TF32_FLOPS)
    f_host = _host_us(f_fns["kernel"])
    print(f"[time] fv_moments D={D} K={K} n={n}: one call at a time kernel "
          f"{f_ms:.4f} ms, plain {f_plain_ms:.4f} ms, torch.addmm x2 (both "
          f"GEMMs) {f_library_ms:.4f} ms; device time alone (CUDA graph): "
          f"kernel {f_dev['kernel']:.4f} ms, plain {f_dev['plain']:.4f} ms, "
          f"torch.addmm x2 {f_dev['library']:.4f} ms; bound {f_bound_ms:.4f} "
          f"ms by {f_bound_by} (3xTF32: {f_ops / 1e9:.2f} GFLOP at the TF32 "
          f"peak, {f_bytes / 1e6:.1f} MB), {f_ops / f_dev['kernel'] / 1e9:.1f}"
          f" TFLOP/s achieved; wrapper host time {f_host:.1f} us a call",
          flush=True)
    del X, means, variances, weights, XX, AB, Xm, post, terms, f_fns
    # the widened path: 4000 components at D = 8, past the llh tile, over
    # an image's descriptors, beside the plain version and both GEMMs
    D, K = 8, 4000
    X, means, variances, weights = _fv_inputs(rng, D, K, n, dev)
    terms = kernels.fv_terms(means, variances, weights)
    XX = torch.cat([X * X, X]).T.contiguous()
    AB = torch.cat([0.5 / variances, -means / variances]).contiguous()
    Xm = torch.cat([X, X * X]).contiguous()
    post = _posteriors(X.T, means.T, variances.T, weights, 1e-4).contiguous()
    c0 = torch.zeros(K, device=dev)
    s0 = torch.zeros(2 * D, K, device=dev)
    w_fns = {
        "kernel": lambda: kernels.fv_moments(X, means, variances, weights,
                                             1e-4, terms=terms),
        "plain": lambda: kernels.fv_moments_plain(X, means, variances,
                                                  weights, 1e-4),
        "library": lambda: (torch.addmm(c0, XX, AB),
                            torch.addmm(s0, Xm, post)),
    }
    w_call = {name: _time_ms(fn, reps=5) for name, fn in w_fns.items()}
    w_dev = {name: _device_ms(fn, reps=3) for name, fn in w_fns.items()}
    del XX, AB, Xm, post
    # held against the plain version at this n, on the descriptors whose
    # float64 posteriors all lie clear of the threshold (a posterior
    # within float32 rounding of it may be kept by one side and dropped
    # by the other)
    q64 = _posteriors(X.T.double(), means.T.double(), variances.T.double(),
                      weights.double(), 0.0)
    clear = ((q64.log() - np.log(1e-4)).abs() > FV_CLEAR).all(dim=1)
    del q64
    Xc = X[:, clear].contiguous()
    got = kernels.fv_moments(Xc, means, variances, weights, 1e-4,
                             terms=terms)
    want = kernels.fv_moments_plain(Xc, means, variances, weights, 1e-4)
    _sync()
    w_errs = []
    for name, g, w in zip(("s0", "s1", "s2"), got, want):
        assert bool(torch.isfinite(g).all())
        err = float((g - w).abs().max())
        scale = float(w.abs().max())
        w_errs.append(f"{name} {err / scale:.3e}")
        assert err <= FV_TOL * scale, (D, K, Xc.shape[1], name, err, scale)
    print(f"[time] fv_moments D={D} K={K} n={n} (components in chunks: the "
          f"column statistics, then the moments): one call at a time kernel "
          f"{w_call['kernel']:.4f} ms, plain {w_call['plain']:.4f} ms, "
          f"torch.addmm x2 (both GEMMs) {w_call['library']:.4f} ms; device "
          f"time alone (CUDA graph): kernel {w_dev['kernel']:.4f} ms, plain "
          f"{w_dev['plain']:.4f} ms, torch.addmm x2 {w_dev['library']:.4f} "
          f"ms; bound "
          f"{_fv_bound(D, K, n)[1]:.4f} ms "
          f"(3xTF32, one llh and one moment product); against plain on the "
          f"{Xc.shape[1]} of {n} descriptors clear of the threshold, "
          f"relative to the largest sum: {', '.join(w_errs)}", flush=True)
    del X, means, variances, weights, terms, w_fns, Xc, got, want
    inet_times = _time_imagenet_kernels(kernels, sift, dev)

    # -- 6. report ------------------------------------------------------------
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_cifar_featurize",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fused_featurize.cu",
        "replaces": "keystone_tpu/ops/pallas_kernels.py:290",
        "launches": launches["fused_cifar_featurize"],
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
        "device_ms": fz_dev["kernel"],
        "library_device_ms": fz_dev["library"],
        "launches_by_path": {"4": launches["fused_cifar_featurize"],
                             "4b": stream_launches["fused_cifar_featurize"],
                             "4c": serve_launches["fused_cifar_featurize"],
                             "4m": fleet_launches["replayed"][
                                 "fused_cifar_featurize"],
                             "4m re-admission": fleet_launches["eager"].get(
                                 "fused_cifar_featurize", 0),
                             "4e": solver_launches["fused_cifar_featurize"],
                             "4e streamed": solver_stream_launches[
                                 "fused_cifar_featurize"],
                             "4i default fit": cache_launches["default"],
                             "4i auto-cache fit": cache_launches[
                                 "auto-cache"],
                             "4r(a) rank 0": world_launches["a"][
                                 "fused_cifar_featurize"],
                             "4r(b) rank 0": world_launches["b"][
                                 "fused_cifar_featurize"],
                             "4t": api_launches.get(
                                 "fused_cifar_featurize", 0)},
    }, {
        "name": "gram_cross",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/gram_cross.cu",
        "replaces": "keystone_tpu/ops/pallas_kernels.py:101",
        "launches": stream_launches["gram_cross"],
        "max_abs_err": gram_worst,
        "ms": g_ms,
        "plain_ms": g_plain_ms,
        "bound_ms": g_bound_ms,
        "bound_by": g_bound_by,
        "library_ms": g_library_ms,
        "device_ms": g_dev["kernel"],
        "library_device_ms": g_dev["library"],
        "launches_by_path": {"4": launches["gram_cross"],
                             "4b": stream_launches["gram_cross"],
                             "4e": solver_launches["gram_cross"],
                             "4e streamed": solver_stream_launches[
                                 "gram_cross"],
                             "4l resumed": resilience_gram,
                             "4r(a) rank 0": world_launches["a"][
                                 "gram_cross"],
                             "4r(b) rank 0": world_launches["b"][
                                 "gram_cross"],
                             "4r(d)": world_launches["d"]["gram_cross"]},
    }, {
        "name": "quantized_affine",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/quantized_affine.cu",
        "replaces": "keystone_tpu/ops/pallas_kernels.py:630",
        "launches": serve_launches["quantized_affine"],
        "max_abs_err": quant_worst,
        "ms": q["ms"],
        "plain_ms": q["plain_ms"],
        "bound_ms": q["bound_ms"],
        "bound_by": q["bound_by"],
        "library_ms": q["library_ms"],
        "device_ms": q["device_ms"],
        "library_device_ms": q["library_device_ms"],
        "launches_by_path": {"4c": serve_launches["quantized_affine"],
                             "4m": fleet_launches["replayed"][
                                 "quantized_affine"],
                             "4m re-admission": fleet_launches["eager"].get(
                                 "quantized_affine", 0),
                             "4r(d)": world_launches["d"][
                                 "quantized_affine"],
                             "4s(d) profile_imagenet's gates":
                                 tools_launches.get("quantized_affine", 0)},
    }, {
        "name": "banded_matmul",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/banded_matmul.cu",
        "replaces": "keystone_tpu/ops/pallas_kernels.py:424",
        "launches": voc_launches["banded_matmul"],
        "max_abs_err": banded_worst,
        "ms": b_ms,
        "plain_ms": b_plain_ms,
        "bound_ms": b_bound_ms,
        "bound_by": b_bound_by,
        "library_ms": b_library_ms,
        "device_ms": b_dev["kernel"],
        "library_device_ms": b_dev["library"],
        "launches_by_path": {"4d": voc_launches["banded_matmul"],
                             "4j": inet_launches["banded_matmul"],
                             "4n(a) VOC from tars":
                                 voc_tar_launches["banded_matmul"],
                             "4n(b) streamed tar": stream_tar_launches[
                                 "banded_matmul"],
                             "4n(c) ImageNet test from tars":
                                 inet_tar_launches["banded_matmul"],
                             "4s(d) profile_imagenet": tools_launches.get(
                                 "banded_matmul", 0)},
        "imagenet": inet_times["banded_matmul"],
    }, {
        "name": "fv_moments",
        "route": "cuda",
        "source": "keystone_tpu_torch/csrc/fv_moments.cu",
        "replaces": "keystone_tpu/ops/pallas_kernels.py:548",
        "launches": voc_launches["fv_moments"],
        "max_abs_err": fv_worst,
        "ms": f_ms,
        "plain_ms": f_plain_ms,
        "bound_ms": f_bound_ms,
        "bound_by": f_bound_by,
        "library_ms": f_library_ms,
        "device_ms": f_dev["kernel"],
        "library_device_ms": f_dev["library"],
        "launches_by_path": {"4d": voc_launches["fv_moments"],
                             "4j": inet_launches["fv_moments"],
                             "4n(a) VOC from tars":
                                 voc_tar_launches["fv_moments"],
                             "4n(c) ImageNet test from tars":
                                 inet_tar_launches["fv_moments"],
                             "4s(d) profile_imagenet": tools_launches.get(
                                 "fv_moments", 0)},
        "imagenet": [inet_times[f"fv_moments n={n}"] for n in INET_FV_N],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


#: phase 4r's bars against phases 4 and 4b (see the module docstring)
WORLD_ERROR_DRIFT, WORLD_AGREE, WORLD_W_TOL = 0.002, 0.99, 5e-3
WORLD_RANKS, WORLD_TIMEOUT_S = 2, 600


def _world_member(spec_path, pid, nproc, store) -> int:
    """One rank of phase 4r's world (``chip_smoke.py --world-member SPEC
    <pid> <nproc> <store>``, launched by ``DryrunWorld``): (a) the CIFAR
    app's ``main`` on the binary files, (b) phase 4b's streamed fit over
    the rank's block. Rank 0 writes the weights and predictions; every
    rank prints its launches and seconds. A failure ends the rank at
    once (its peer then fails in its next gather)."""
    sys.path.insert(0, REPO)
    try:
        return _world_member_run(spec_path, int(pid), int(nproc), store)
    except BaseException:
        import traceback

        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


def _world_member_run(spec_path, pid, nproc, store) -> int:
    import torch.distributed as dist

    from keystone_tpu_torch.loaders.cifar_loader import cifar_loader
    from keystone_tpu_torch.nodes.learning.zca import ZCAWhitener
    from keystone_tpu_torch.nodes.util import (
        ClassLabelIndicatorsFromIntLabels,
    )
    from keystone_tpu_torch.observability.metrics import MetricsRegistry
    from keystone_tpu_torch.ops import kernels
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.parallel.mesh import (
        initialize_distributed,
        local_mesh,
        mesh_scope,
        shard_bounds,
        shutdown_distributed,
    )
    from keystone_tpu_torch.parallel.streaming import StreamingDataset
    from keystone_tpu_torch.pipelines.images.cifar import (
        random_patch_cifar as rpc,
    )
    from keystone_tpu_torch.workflow.common import Cacher
    from keystone_tpu_torch.workflow.env import PipelineEnv

    with open(spec_path) as f:
        spec = json.load(f)
    w = initialize_distributed(store, nproc, pid, device="cuda")
    dev = w.device
    # rank 0 builds (a hit on the parent's build), the others after it
    if pid == 0:
        kernels.build_kernels()
    dist.barrier(group=w.cpu_group)
    kernels.build_kernels()
    tag = f"[4r] rank {pid} of {nproc}"
    print(f"{tag}: backend {w.backend} ({w.rule}), device {dev}",
          flush=True)

    # (a) the app's main: each rank fits its block of the rows
    kernels.reset_launches()
    _sync()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        pipeline, _, test_eval = rpc.main(spec["app_argv"])
    _sync()
    app_s = time.time() - t0
    launches_a = dict(kernels.LAUNCHES)
    test = cifar_loader(spec["test_bin"], device=dev)
    preds = pipeline.apply(test.data).get().numpy()
    W_a = torch.as_tensor(_operator(pipeline, "BlockLinearMapper").weights)
    print(f"{tag} (a): cifar.random_patch main {app_s:.2f} s (load, filter "
          f"learning, fit on its rows, evaluation), test error "
          f"{test_eval.total_error:.4f}, launches {launches_a}; "
          f"{out.getvalue().splitlines()[-1]}", flush=True)
    del pipeline, test
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()

    # (b) phase 4b's streamed fit: this rank's block of the chunks
    X = np.load(spec["tr_x"], mmap_mode="r")
    y = np.load(spec["tr_y"])
    b = shard_bounds(X.shape[0], nproc)
    lo, hi = int(b[pid]), int(b[pid + 1])
    blob = np.load(spec["filters"])
    filters = blob["filters"]
    whitener = ZCAWhitener(blob["whitener"], blob["means"])
    config = rpc.RandomCifarConfig(num_filters=filters.shape[0],
                                   lam=float(spec["lam"]), seed=SEED)
    reg = MetricsRegistry.get_or_create()
    with mesh_scope(local_mesh()):
        stream = StreamingDataset.from_numpy(
            np.ascontiguousarray(X[lo:hi]), spec["chunk"], device=dev,
            prefetch_depth=spec["depth"], tag="cifar-train")
        labels = (ClassLabelIndicatorsFromIntLabels(rpc.NUM_CLASSES)
                  >> Cacher("labels"))(ArrayDataset.from_numpy(
                      y[lo:hi].astype(np.int32), dev))
        kernels.reset_launches()
        merges = reg.histogram("coord.merge_s").snapshot()
        _sync()
        t0 = time.time()
        fitted = rpc.build_pipeline(filters, whitener, config, stream,
                                    labels).fit()
        _sync()
        stream_s = time.time() - t0
    launches_b = dict(kernels.LAUNCHES)
    after = reg.histogram("coord.merge_s").snapshot()
    merge_s = after["total"] - merges["total"]
    occ = reg.snapshot()["gauges"].get("coord.overlap_occupancy")
    W_b = torch.as_tensor(_operator(fitted, "BlockLinearMapper").weights)
    print(f"{tag} (b): streamed fit of rows [{lo}, {hi}) "
          f"({-(-(hi - lo) // spec['chunk'])} chunks of {spec['chunk']}, "
          f"depth {spec['depth']}) {stream_s:.2f} s, the carries' merges "
          f"{merge_s:.3f} s ({after['count'] - merges['count']} merges: the "
          f"scaler's moments and the 8192 x 8192 Gram carry), "
          f"coord.overlap_occupancy {occ}, launches {launches_b}", flush=True)
    if pid == 0:
        np.savez(spec["out"], W_a=W_a.float().cpu().numpy(), preds=preds,
                 test_error=np.array(test_eval.total_error),
                 W_b=W_b.float().cpu().numpy(),
                 launches=json.dumps({"a": launches_a, "b": launches_b}),
                 merge_s=np.array(merge_s), app_s=np.array(app_s),
                 stream_s=np.array(stream_s),
                 occupancy=np.array(-1.0 if occ is None else occ))
    dist.barrier(group=w.cpu_group)
    shutdown_distributed()
    return 0


def _world_phase(kernels, rpc, tr_x, tr_y, te_x, filters, whitener, config,
                 preds, rp_test, resident_W, stream_W, model_path, ci_log,
                 workdir, dev, smi):
    """Phase 4r (see the module docstring). Returns each kernel's
    launches on 4r's paths (rank 0's for the world)."""
    from keystone_tpu_torch.nodes.learning.linear import BlockLinearMapper
    from keystone_tpu_torch.ops import linalg
    from keystone_tpu_torch.parallel.distributed import (
        DryrunWorld,
        WorldCoordinator,
    )
    from keystone_tpu_torch.parallel.mesh import (
        initialize_distributed,
        shutdown_distributed,
        world_data_mesh,
    )
    from keystone_tpu_torch.parallel.spmd_apply import sharded_apply
    from keystone_tpu_torch.utils.checkpoint import load_pipeline

    t_phase = time.time()
    _release()
    train_bin = os.path.join(workdir, "cifar_train.bin")
    test_bin = os.path.join(workdir, "cifar_test.bin")
    assert os.path.exists(train_bin) and os.path.exists(test_bin)
    spec = {
        "app_argv": ["--trainLocation", train_bin, "--testLocation",
                     test_bin, "--numFilters", str(config.num_filters),
                     "--lambda", str(config.lam), "--seed",
                     str(config.seed), "--device", "cuda"],
        "test_bin": test_bin, "tr_x": os.path.join(workdir, "w_tr_x.npy"),
        "tr_y": os.path.join(workdir, "w_tr_y.npy"),
        "filters": os.path.join(workdir, "w_filters.npz"),
        "chunk": CHUNK, "depth": DEPTH, "lam": config.lam,
        "out": os.path.join(workdir, "w_out.npz")}
    np.save(spec["tr_x"], tr_x)
    np.save(spec["tr_y"], tr_y)
    np.savez(spec["filters"], filters=filters, whitener=whitener.whitener,
             means=whitener.means)
    spec_path = os.path.join(workdir, "w_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    # the same main on the same files in this process, without a world:
    # the binary files hold the surrogate's pixels rounded to bytes, so
    # the filters the app learns, and with them the weights, are not
    # phase 4's; the world's weights are held against this fit's
    kernels.reset_launches()
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        solo_fit, _, solo_eval = rpc.main(spec["app_argv"])
    _sync()
    solo_s = time.time() - t0
    solo_W = torch.as_tensor(
        _operator(solo_fit, "BlockLinearMapper").weights).float().cpu()
    solo_launches = dict(kernels.LAUNCHES)
    del solo_fit
    _release()

    # (a) and (b): one world of 2 ranks on this card
    world = DryrunWorld(WORLD_RANKS, workdir=os.path.join(workdir, "world"),
                        grace_s=60)
    t0 = time.time()
    world.launch([sys.executable, os.path.abspath(__file__),
                  "--world-member", spec_path])
    codes = world.wait(timeout_s=WORLD_TIMEOUT_S)
    world_s = time.time() - t0
    for p in range(WORLD_RANKS):
        for line in world.output(p).splitlines():
            if line.startswith(("[4r]", "world:")):
                print(line if line.startswith("[4r]") else f"[4r] {line}",
                      flush=True)
    assert codes == [0] * WORLD_RANKS, (
        codes, [world.output(p)[-3000:] for p in range(WORLD_RANKS)])
    got = np.load(spec["out"])
    launches = json.loads(str(got["launches"]))
    W_a = torch.from_numpy(got["W_a"])
    test_err = float(got["test_error"])
    agree = float(np.mean(got["preds"] == preds))
    wa_rel = float((W_a - solo_W).abs().max() / solo_W.abs().max())
    w4_rel = float((W_a - resident_W.cpu()).abs().max()
                   / resident_W.abs().max())
    solo4_rel = float((solo_W - resident_W.cpu()).abs().max()
                      / resident_W.abs().max())
    print(f"[4r] (a) world of {WORLD_RANKS} (launch to exit {world_s:.1f} s):"
          f" test error {test_err:.4f} against phase 4's {rp_test:.4f}, "
          f"predictions agree with phase 4's on {agree:.4f} of test images, "
          f"max |W_world - W_one| / max |W_one| {wa_rel:.3e} against the "
          f"same main on the same files in one process ({solo_s:.2f} s, "
          f"test error {solo_eval.total_error:.4f}, launches "
          f"{solo_launches}); against phase 4's weights: the world "
          f"{w4_rel:.3e}, the one-process run {solo4_rel:.3e} (the files' "
          f"pixels are rounded to bytes, so the filters differ); rank 0 "
          f"launches {launches['a']}", flush=True)
    assert abs(test_err - rp_test) <= WORLD_ERROR_DRIFT, (test_err, rp_test)
    assert agree >= WORLD_AGREE, agree
    assert wa_rel <= WORLD_W_TOL, wa_rel
    assert launches["a"]["fused_cifar_featurize"] > 0, launches
    assert launches["a"]["gram_cross"] > 0, launches
    W_b = torch.from_numpy(got["W_b"])
    wb_rel = float((W_b - stream_W.cpu()).abs().max() / stream_W.abs().max())
    n_local = -(-(N_TRAIN // WORLD_RANKS) // CHUNK)
    print(f"[4r] (b) streamed world fit: max |W_world - W_4b| / max |W_4b| "
          f"{wb_rel:.3e}, carry merges {float(got['merge_s']):.3f} s, "
          f"coord.overlap_occupancy {float(got['occupancy']):.4f}, rank 0 "
          f"launches {launches['b']}", flush=True)
    assert launches["b"]["gram_cross"] == n_local, launches
    assert launches["b"]["fused_cifar_featurize"] == 2 * n_local, launches
    assert wb_rel <= WORLD_W_TOL, wb_rel

    # (c) the elastic gate, run on the card by 4q's CI chain
    gate = [line for line in ci_log.splitlines()
            if line.startswith("elastic gate: ")]
    for line in gate:
        print(f"[4r] (c) {line}", flush=True)
    assert "elastic gate: PASS" in gate, gate
    assert any("on cuda" in line for line in gate), gate

    # (d) an NCCL world of 1 here: each result against the same call
    # without a world
    fitted = load_pipeline(model_path, device=dev)
    mapper = _operator(fitted, "BlockLinearMapper")
    featurizer = _operator(fitted, "FusedConvRectifyPool")
    scaler = _operator(fitted, "StandardScalerModel")
    X = scaler.apply_batch(featurizer.apply_batch(
        torch.as_tensor(te_x, device=dev))).contiguous()
    int8 = BlockLinearMapper(mapper.block_weights, mapper.block_size,
                             intercept=mapper.intercept,
                             feature_means=mapper.feature_means,
                             weight_dtype="int8")
    carry = (X.T @ X, X.sum(dim=0), int(X.shape[0]))
    solo = {"f32": sharded_apply(mapper, X), "int8": sharded_apply(int8, X),
            "gram": kernels.gram_cross(X, X[:, :0])[0]}
    kernels.reset_launches()
    store = "file://" + os.path.join(workdir, "nccl_store")
    w = initialize_distributed(store, 1, 0, device="cuda", quiet=True)
    try:
        mesh = world_data_mesh()
        t0 = time.time()
        merged = WorldCoordinator("4r").merge_carries(carry)
        gram = linalg.gram(X, mesh)
        f32 = sharded_apply(mapper, X, mesh)
        q8 = sharded_apply(int8, X, mesh)
        _sync()
        nccl_s = time.time() - t0
        backend, rule = w.backend, w.rule
    finally:
        shutdown_distributed()
    same = {"merge_carries": torch.equal(merged[0], carry[0])
            and torch.equal(merged[1], carry[1]) and merged[2] == carry[2],
            "gram": torch.equal(gram, solo["gram"]),
            "sharded_apply f32": torch.equal(f32, solo["f32"]),
            "sharded_apply int8": torch.equal(q8, solo["int8"])}
    d_launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    print(f"[4r] (d) world of 1, backend {backend} ({rule}): torch.equal to "
          f"the calls without a world {same}, {nccl_s:.3f} s, launches "
          f"{d_launches}; multi-rank NCCL needs more than one card", flush=True)
    assert backend == "nccl", backend
    assert all(same.values()), same
    assert d_launches.get("gram_cross") == 1 and d_launches.get(
        "quantized_affine") == 1, d_launches
    del fitted, mapper, int8, X, carry, solo, merged, gram, f32, q8
    _release()
    print(f"[4r] phase 4r in {time.time() - t_phase:.1f} s; {smi}",
          flush=True)
    return {"a": launches["a"], "b": launches["b"], "d": d_launches}


#: phase 4s's shapes: profile_solver's CIFAR scale, profile_imagenet's batch
TOOLS_SOLVER_SHAPE = (50_000, 4_096, 10)
TOOLS_INET_IMAGES, TOOLS_INET_HW = 16, (480, 640)


def _tools_phase(kernels, static_4e, workdir, dev, smi):
    """Phase 4s (see the module docstring). Returns the kernel launches of
    ``profile_imagenet`` (its profile and its gates)."""
    from keystone_tpu_torch.nodes.learning.least_squares import (
        REFERENCE_EC2_WEIGHTS as EC2,
        load_calibration,
    )
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator,
        LinearMapEstimator,
    )
    from keystone_tpu_torch.tools import (
        calibrate_cost_model as cal,
        elastic_bench,
        profile_imagenet,
        profile_solver,
    )

    t_phase = time.time()
    # -- (a) the calibration, at full size, into the run's directory
    path = os.path.join(workdir, "calibration", "cost_model_calibration.json")
    t0 = time.time()
    res = cal.calibrate(dev, small=False, out_path=path)
    weights = res["weights"]
    print(f"[4s(a)] calibration in {time.time() - t0:.1f} s on {smi}: "
          f"float32 Gram {res['flop_rate'] / 1e12:.3f} TFLOP/s, stream "
          f"{res['stream_rate'] * 4 / 1e9:.1f} GB/s; weights (card against "
          "EC2): " + ", ".join(f"{k} {weights[k]:.4e} against {EC2[k]:.4e}"
                                for k in weights), flush=True)
    # the rounds the cost model charges lat_w for: one an L-BFGS iteration
    rounds = {"dense_lbfgs": 20,
              "block_ls": BlockLeastSquaresEstimator.DISPATCH_ROUNDS,
              "exact": LinearMapEstimator.DISPATCH_ROUNDS}
    for r in res["shapes"]:
        print(f"[4s(a)] ({r['n']}, {r['d']}, {r['k']}): " + ", ".join(
            f"{name} {sec * 1e3:.2f} ms ({r['host_syncs'][name]} host syncs "
            f"a fit, the model's rounds {rounds[name]})"
            for name, sec in r["seconds"].items())
            + f"; measured fastest {r['measured_fastest']}, the card's "
            f"model picks {r['model_pick']}", flush=True)
    print(f"[4s(a)] agreement {res['agreement']}/{res['checked']}; "
          f"artifact {res['path']}", flush=True)
    if res["path"] is not None:
        loaded, provenance = load_calibration(path)
        print(f"[4s(a)] load_calibration of the artifact: {provenance}",
              flush=True)
        assert provenance["source"] == "artifact", provenance
        assert loaded == weights, (loaded, weights)
    else:
        assert 2 * res["agreement"] <= res["checked"], res
        assert not os.path.exists(path), path

    # -- (b) the card's weights applied (printed, not asserted)
    n, d, k = N_TRAIN, 8 * NUM_FILTERS, 10
    for streaming in (False, True):
        ec2 = cal.choice_at(EC2, n, d, k, streaming=streaming)
        card = cal.choice_at(weights, n, d, k, streaming=streaming)
        print(f"[4s(b)] LeastSquaresEstimator(lam=10) at 4e's "
              f"{'streamed' if streaming else 'resident'} shape ({n}, {d}, "
              f"{k}), density 1, 1 machine: EC2 weights pick {ec2}, the "
              f"card's weights pick {card}", flush=True)
        if not streaming:
            secs = static_4e["candidate_s"]
            fastest = min(secs, key=secs.get)
            print(f"[4s(b)] 4e measured there: " + ", ".join(
                f"{name} {sec:.4f} s" for name, sec in secs.items())
                + f"; fastest {fastest}; the card's choice is it: "
                f"{card.split('(')[0] == fastest}", flush=True)
    for app, node, shape, picks in cal.app_choices({"EC2": EC2,
                                                    "card": weights}):
        print(f"[4s(b)] {app}: {node} at (n, item) = {shape}: EC2 picks "
              f"{picks['EC2']}, the card's weights pick {picks['card']}",
              flush=True)

    # -- (c) the block solve's operations at CIFAR scale
    print(f"[4s(c)] profile_solver at {TOOLS_SOLVER_SHAPE} on {smi}",
          flush=True)
    profile_solver.profile(*TOOLS_SOLVER_SHAPE, dev)
    gc.collect()
    torch.cuda.empty_cache()

    # -- (d) the SIFT -> PCA -> FV stage profile, its gates asserted
    print(f"[4s(d)] profile_imagenet at {TOOLS_INET_IMAGES} images of "
          f"{TOOLS_INET_HW} on {smi}", flush=True)
    t0 = time.time()
    prof = profile_imagenet.run(TOOLS_INET_IMAGES, TOOLS_INET_HW, dev)
    print(f"[4s(d)] in {time.time() - t0:.1f} s; launches "
          f"{prof['launches']}", flush=True)
    assert prof["launches"].get("banded_matmul", 0) > 0, prof["launches"]
    assert prof["launches"].get("fv_moments", 0) > 0, prof["launches"]
    gc.collect()
    torch.cuda.empty_cache()

    # -- (e) the 1-against-2-rank scaling bench, 2 gloo ranks on the card
    t0 = time.time()
    for line in elastic_bench.bench(device="cuda"):
        print(f"[4s] {json.dumps(line)}", flush=True)
    print(f"[4s(e)] elastic bench in {time.time() - t0:.1f} s", flush=True)
    print(f"[4s] phase 4s in {time.time() - t_phase:.1f} s; {smi}",
          flush=True)
    return prof["launches"]

#: phase 4t's bars (see the module docstring): the objective against
#: float64, and apply_and_evaluate's last partial against apply (the JAX
#: test's bar)
API_COST_RTOL = 1e-4
API_PARTIAL_TOL = 2e-3


def _api_phase(kernels, mapper, featurizer, scaler, tr_x, tr_y, te_x, te_y,
               lam, rp_test, mnist_4f, dev, smi):
    """Phase 4t (see the module docstring). Returns its kernel launches
    (the featurize kernel's, making (a)'s and (b)'s features)."""
    from keystone_tpu_torch.evaluation.multiclass import evaluate_multiclass
    from keystone_tpu_torch.loaders.csv_loader import LabeledData
    from keystone_tpu_torch.nodes.learning.linear import (
        BlockLeastSquaresEstimator,
        LinearMapEstimator,
    )
    from keystone_tpu_torch.observability.trace import PipelineTrace
    from keystone_tpu_torch.parallel.dataset import ArrayDataset
    from keystone_tpu_torch.pipelines.images.mnist import random_fft
    from keystone_tpu_torch.workflow.env import PipelineEnv

    t_phase = time.time()
    kernels.reset_launches()
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()

    def features(images):
        return torch.cat([scaler.apply_batch(featurizer.apply_batch(
            torch.as_tensor(images[i:i + CHUNK], device=dev)))
            for i in range(0, len(images), CHUNK)])

    # -- (a) the objectives at phase 4's fitted point ------------------------
    bounds = mapper._block_bounds()
    Ws = [torch.as_tensor(w, device=dev).float() for w in mapper.block_weights]
    b = torch.as_tensor(mapper.intercept, device=dev).float()
    mean = torch.as_tensor(mapper.feature_means, device=dev).float()
    Xc = features(tr_x) - mean
    Y = torch.where(torch.arange(10, device=dev) == torch.as_tensor(
        tr_y, device=dev)[:, None], 1.0, -1.0)
    t0 = time.time()
    block_cost = BlockLeastSquaresEstimator.compute_cost(
        [Xc[:, lo:hi] for lo, hi in bounds], Y, lam, Ws, b)
    block_s = time.time() - t0
    t0 = time.time()
    full_cost = LinearMapEstimator.compute_cost(Xc, Y, lam, torch.cat(Ws), b)
    full_s = time.time() - t0
    pred64 = b.double().expand(N_TRAIN, -1).clone()
    for (lo, hi), w in zip(bounds, Ws):
        pred64 += Xc[:, lo:hi].double() @ w.double()
    cost64 = float(((pred64 - Y.double()) ** 2).sum() / (2 * N_TRAIN)
                   + lam / 2 * sum((w.double() ** 2).sum() for w in Ws))
    del pred64, Xc, Y
    gaps = {name: abs(cost - cost64) / abs(cost64)
            for name, cost in (("block", block_cost), ("linear", full_cost))}
    print(f"[4t(a)] phase 4's ridge objective at its fitted blocks ({N_TRAIN}"
          f" training rows, {len(bounds)} blocks of {bounds[0][1]} features,"
          f" lam {lam:g}): BlockLeastSquaresEstimator.compute_cost "
          f"{block_cost:.9g} ({block_s * 1e3:.1f} ms), LinearMapEstimator."
          f"compute_cost on the concatenation {full_cost:.9g} "
          f"({full_s * 1e3:.1f} ms), float64 {cost64:.9g}; relative gaps "
          f"{gaps['block']:.3e} and {gaps['linear']:.3e} (bar "
          f"{API_COST_RTOL:g}); {smi}", flush=True)
    assert all(np.isfinite([block_cost, full_cost, cost64])), gaps
    assert max(gaps.values()) <= API_COST_RTOL, gaps

    # -- (b) the per-block evaluation over phase 4's test features -----------
    Xte = features(te_x)
    errors, partials = [], []

    def evaluator(ds):
        out = ds.data[:ds.n]
        partials.append(out)
        errors.append(evaluate_multiclass(
            out.argmax(dim=1).cpu().numpy(), te_y, 10).total_error)

    t0 = time.time()
    mapper.apply_and_evaluate([Xte[:, lo:hi] for lo, hi in bounds],
                              evaluator)
    _sync()
    aae_s = time.time() - t0
    full = mapper.apply_batch(Xte)
    gap = float(((partials[-1] - full).abs()
                 - API_PARTIAL_TOL * full.abs()).max())
    err_gap = abs(errors[-1] - rp_test)
    print(f"[4t(b)] BlockLinearMapper.apply_and_evaluate over phase 4's "
          f"{N_TEST} test features in {len(bounds)} blocks "
          f"({aae_s * 1e3:.1f} ms): test error after each block "
          f"{[round(e, 4) for e in errors]}; the last partial against apply:"
          f" max(|diff| - {API_PARTIAL_TOL:g} |apply|) {gap:.3e} (bar "
          f"{API_PARTIAL_TOL:g}); last error {errors[-1]:.4f}, phase 4's "
          f"{rp_test:.4f} ({err_gap * N_TEST:.0f} test images apart, bar 1);"
          f" {smi}", flush=True)
    assert len(errors) == len(bounds)
    assert bool(torch.isfinite(full).all())
    assert gap <= API_PARTIAL_TOL, gap
    assert err_gap <= 1.0 / N_TEST + 1e-12, (errors[-1], rp_test)
    launches = dict(kernels.LAUNCHES)
    del Xte, partials, full
    gc.collect()
    torch.cuda.empty_cache()

    # -- (c) the rule log of 4f's fit, traced -------------------------------
    config, tx, ty = mnist_4f
    train = LabeledData(ArrayDataset.from_numpy(tx, dev),
                        ArrayDataset.from_numpy(ty, dev))
    PipelineEnv.reset()
    clock = _OptimizerClock()
    t0 = time.time()
    try:
        with PipelineTrace("4t-mnist") as tr:
            fitted = random_fft.build_pipeline(config, train).fit()
            _sync()
    finally:
        clock.close()
    fit_s = time.time() - t0
    by_rule = {}
    for e in tr.optimizer_rules:
        count, secs = by_rule.get(e["rule"], (0, 0.0))
        by_rule[e["rule"]] = (count + 1, secs + e["wall_s"])
    runs = tr.meta.get("optimizer_runs", [])
    fusion = sum(by_rule.get(r, (0, 0.0))[0]
                 for r in ("MapFusionRule", "GatherFusionRule"))
    print(f"[4t(c)] MnistRandomFFT fit of phase 4f, traced: {fit_s:.2f} s; "
          f"rule log: " + ", ".join(
              f"{r} {c} rewrites {s:.4f} s" for r, (c, s) in
              sorted(by_rule.items(), key=lambda kv: -kv[1][1]))
          + f" (host); the clock: {clock.summary()}; {smi}", flush=True)
    for run in runs:
        print(f"[4t(c)] optimizer run: {run['optimizer']} batches "
              f"{run['batches']}, nodes {run['nodes_in']} -> "
              f"{run['nodes_out']}, {run['wall_s']:.4f} s; {smi}",
              flush=True)
    assert len(runs) == clock.counts["execute"] > 0, \
        (len(runs), clock.counts)
    assert 0 < fusion <= clock.counts["fusion rule"], (fusion, clock.counts)
    assert any(r["nodes_in"] > r["nodes_out"] for r in runs), runs
    del fitted, train, tr
    PipelineEnv.reset()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[4t] phase 4t in {time.time() - t_phase:.1f} s; launches "
          f"{launches}; {smi}", flush=True)
    return launches


def _stages(op):
    """The operator and, for a fused node, its stages and branches, in
    order."""
    yield op
    for inner in getattr(op, "stages", ()) or getattr(op, "branches", ()):
        yield from _stages(inner)


def _operator(fitted, type_name):
    """The fitted pipeline's operator of the named type, inside a fused
    node too."""
    g = fitted._graph
    return next(op for n in g.nodes for op in _stages(g.get_operator(n))
                if type(op).__name__ == type_name)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--world-member"]:
        sys.exit(_world_member(*sys.argv[2:]))
    sys.exit(main())
