#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit;
2. builds the port's CUDA kernels from ``classpose_tpu_torch/csrc`` with
   nvcc (one process per source, in parallel) and prints the build time;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it (attention forward: 25 crops × 16 heads
   × 1024 tokens, bf16; attention backward: 8 crops × 16 heads × 1024
   tokens, bf16; sampler and diffusion: 8 tiles of 1024²; histogram: 8
   tiles of 1024² on a uniform input (pixels land within ±8 px of
   themselves) and a converged one (every foreground pixel of the design
   field on its cell's centre, the line's numbers), and on the eval_batch
   path's own input from step 4's warm-up; LayerNorm: (25, 1024, 1024)
   bf16 with the fast variance and (25, 32, 32, 256) bf16 two-pass;
   kernel 4 also on a 512² training target at 1200 iterations, with its
   launches per call; kernel 7 (the diffusion from a start field, on
   kernel 4's body), bitwise, timed with its launches per call at the
   evaluate QC of one 448² image at niter 80 (the line's numbers, with
   the wall of one call given an int count, which reads nothing back), a
   500² target at 100, 8 × 448² at 40/80/120, a 2048² target at 120 and
   8 × 1024² at 40/80/120 (beside kernel 4), plus counts off multiples
   of k from a nonzero start on raw labels;
   head-major attention: 8 crops × 16 heads × 1024 tokens in fp32 and
   bf16) and times kernel, plain version, a one-call PyTorch yardstick
   where there is one (for the attention forwards the fastest SDPA
   backend that takes a float mask, named, with its spread) and the
   least time the card could take (the bound); checks kernel 1's
   log-sum-exp and fp32 output at 8 × 16 × 1024, sampler and histogram
   also at 8 × 448², 300 × 500 and widths off a multiple of 4 (2 × 130 ×
   70, 1 × 257 × 1023), and that the LayerNorm and head-major
   attention kernel routes raise where a gradient would flow through
   them; then the attention kernels on the token grids of other crop
   sizes (28 × 28, 64 × 64, 12 × 20, 8 × 128 and 128 × 128: kernels 1, 8
   in fp32 and bf16, and 5), each against its plain version;
4. runs ``ClassposeModel.eval_batch`` at full ViT-L width (24 blocks,
   1024 wide, bf16) with the structured synthetic checkpoint on 8 uint8
   tiles of 1024², ``batch_size=32``, ``niter=200``, with every launch
   count reset just before and read just after; checks ~1k instances per
   tile, that every kernel was launched, and that the masks agree with a
   run of the same slice with the plain versions swapped in; then runs
   the same batch again with ``CLASSPOSE_LN_PALLAS=1`` (400 LayerNorm
   launches: 48 block and 2 neck calls per tile's 25-crop chunk) and
   compares its masks with the first run's; then ``--fast_qc``'s settings
   (``qc_downsample=2``, ``percentile_subsample=2``) on the same batch as
   float tiles, whose masks must equal those of the same call with the
   plain versions (worst IoU 1.0), and kernel 4 at that call's QC shape
   (8 × 512², one count for the batch), captured from the call, bitwise
   against its plain version, timed, with its launches per call against
   ``diffusion_plan``;
5. runs the training slice at full ViT-L width in bf16 (``rdrop`` 0.4,
   seeded random weights): synthetic disc images through
   ``process_train_test`` (flow targets by the diffusion kernel) and
   ``ClassposeTrainingDataset``, then ``train_class_seg`` for 3 epochs of
   2 steps at batch 8, with every launch count reset just before and
   read just after; checks the diffusion ran for the targets, finite
   losses, moved parameters and ``depth`` launches of each attention
   kernel per step; times one batch of augmentation and one save of the
   final weights (the trainer's host work; its ``.npz`` written
   uncompressed, as every phase writes it: the compressed save took
   73.6 s of host zlib on the card's host), the train step at batch 8
   (median, imgs/s, peak memory, MFU), and traces one step; then takes
   one step at batch 2
   without layer-drop, checks that every attention parameter got a
   finite non-zero gradient, and compares loss and gradients with the
   same step with the plain versions swapped in; then the same check for
   one step at batch 8 of 224² crops (28 × 28 tokens); then the reader
   step: the committed ``tests/golden/hdf5_latest.h5`` (h5py under
   ``libver="latest"``: fixed- and extensible-array chunk indexes,
   shuffle, deflate, fletcher32, lzf, szip, compact and big-endian
   datasets, dense links) read by the package's own reader, every dataset
   to h5py's digest (``hdf5_golden.json``), then 2 train steps at batch 2
   on its ``ClassposeHDF5Dataset`` items, full ViT-L width in bf16 (the
   trainer's kernel route): ``depth`` launches of kernels 1 and 5 a step,
   finite losses; then the goldens under that file's ``"more"`` (h5py's
   defaults with soft links, a dangling one among them, and lzf after
   scaleoffset in chunks scaleoffset outgrows; shared object header
   messages indexed by a list and by a B-tree; the nbit filter at reduced
   precision), every dataset to h5py's digest, each dangling link listed
   and read as missing, and 2 more steps on the items of
   ``ClassposeHDF5Dataset`` over the default-layout file, whose
   ``images`` and ``labels`` are soft links, with the same launch counts;
   then the training
   CLI phase on the same 16 images written as ``images.npy`` /
   ``labels.npy``: ``classpose-dataset-to-hdf5-torch``
   (``dataset_to_hdf5.main_with_args``, targets by kernel 4 on the card,
   the file by the package's own HDF5 writer) must launch kernel 4, and
   the file read back by the package's reader must hold bit for bit the
   images, labels, diameters and class and instance counts of the
   training phase's targets; each colour and quality transform of the
   ``enhanced`` augmentation, forced to fire, is timed alone on one 512²
   item (the median of 5 calls), then one batch of 4 items of
   ``ClassposeHDF5Dataset(..., augmentation_strategy="enhanced")``;
   then ``classpose-train-torch`` (``run_training.main_with_args``) on
   the ``.h5`` with ``--augmentation enhanced``, 2 epochs at batch 4, at
   its defaults (full ViT-L, fp32, ``--device auto``; its ``.npz``
   written uncompressed, as below): every logged loss
   finite, the weights written and loaded by ``load_checkpoint`` into a
   model whose ``eval`` of a 256² image gives finite outputs; it prints
   the CLI's wall, its steps and the seconds its items took in
   ``ClassposeHDF5Dataset.__getitem__``; then several ranks: two
   processes run the trainer's configuration above, cut to 4 blocks,
   for its first 2 epochs of 2 steps (epoch 0's learning rate is 0 by
   the schedule, so a single epoch would move no weight) at 4 images a
   rank, global batch 8, on the very items the one-process run drew
   (recorded, then replayed by rank share), with NCCL on two cards
   (``torch.distributed.run``) where two are visible, else both on
   ``cuda:0`` over gloo; both ranks' final weights must be bitwise
   equal, rank 0's ``.npz`` (written uncompressed, as every phase writes
   it) must hold them, and each step's total loss must lie within 1e-4
   of a run of the same 4-block configuration on the same items in this
   process; it prints the route, each rank's imgs/s and peak memory;
6. writes a ViT-L checkpoint whose patch embed and attention are live
   (``perturbed_structured_params`` with ``attn_ripple``, 6 classes) as a
   published ``conic.pt`` (the published key layout, held against the
   ViT-L manifest) and converts it with ``classpose-convert-weights-torch``
   to a native ``.npz`` (written uncompressed, as every phase writes it:
   the later runs load it faster); runs the WSI CLI
   (``entrypoints.predict_wsi.main_with_args``) with
   ``CLASSPOSE_LN_PALLAS=1`` on a ~6144² synthetic slide at 0.4 µm/px
   (25 tiles of 1280² read and resized to 1024² at the config's 0.5 µm/px)
   with that ``.npz`` in bf16, ``--output_type csv spatialdata``: checks
   that the outputs parse, that the cell count lies in the design field's
   range and that all five inference kernels ran; a second run under
   ``--profile`` gives the device's idle share; a third with the plain
   versions swapped in must agree (cell counts within 0.5%, ≥ 99% of
   centroids within 1 px with the same class); then several cards: the
   same slide, checkpoint and flags on two replicas, through the CLI with
   ``--device cuda:0,1`` where two cards are visible, else through
   ``pipeline.predict_wsi.main(..., devices=[cuda:0, cuda:0])``; the five
   kernels must run, both replicas get batches, and its cells must be the
   one-card run's (equal count, every cell matched with its class); the
   run is made once, under ``--profile``; it prints the route, the
   batches dealt to each replica, the seconds (against the one-card
   ``--profile`` run's), the slide tiles/s, the idle share and whether
   the sorted features are byte-identical; then the published
   checkpoint: ``python -m classpose_tpu_torch.entrypoints.predict_wsi
   --model_config conic`` in a process of its own with
   ``CLASSPOSE_MODEL_DIR`` on the ``.pt``'s directory must launch the
   five kernels and find the ``.npz`` run's cells (the same count, every
   cell matched with its class), and ``classpose-parity-check-torch`` on
   the ``.pt`` with one 256² tile on the card (the port's fp32 forward
   against the torch replica, layer by layer) must pass at its default
   ``--atol``; then the CLI once more with ``--fast_qc``, whose cell
   count must lie in the design field's range; then the slide phase: the
   same slide written by the port's ``write_tiled_tiff`` (512² JPEG
   tiles at quality 80, MPP 0.4 in its Aperio description) as
   ``slide.svs`` and run through the CLI with ``WSI_READER`` unset (the
   port's ``TiffSlide``, the MPP read from the file): the five kernels
   must run, its cells lie within 0.5% of the ``.npy`` run's with ≥ 99%
   matched; its level 0 decoded whole by the reader and run as
   ``decoded.npy`` must find its cells exactly; the golden JPEG
   (``tests/golden``) must decode to the pixels PIL decoded; it prints
   the write seconds and the codec's host rates (encode on one thread,
   decode of level 0's 144 tiles on one and on the loader's 4 reader
   threads) and the SVS run's pipeline and stage seconds beside the
   ``.npy`` run's; its JPEG 2000 step: the golden codestreams and the
   16 tiles of the committed Aperio SVS (``tests/golden/j2k_region.svs``:
   compression 33005, 512² tiles of 9/7 at rate 60, the slide's
   ``[0:2048, 0:2048]`` region, MPP 0.4 in its description) must decode
   on the card's host to the SHA-256 of the pixels PIL decoded
   (``j2k_golden.json``); the SVS run through the CLI with
   ``WSI_READER`` unset (512² model tiles: 9 of them) must launch the
   five kernels and find the cells of the CLI run on that region cut from
   ``slide.npy`` (within 0.5%,
   ≥ 99% matched); its level 0 decoded whole and run as an ``.npy`` must
   find exactly its cells; the ``j2k_ext_*`` goldens (component
   precisions to 20 bits, JP2 files, PPM and PPT, and Part 15 signalling
   over Part 1 code-blocks: Rsiz 0x4000, CAP and CPF) must decode to their
   hashes and the streams still refused (Part 1 data under the HT style
   among them) raise naming what they use; the
   lossless ``tests/golden/j2k_ext_region.svs`` (the same region, its
   tiles in turn 12-bit, JP2-boxed, with PPM and with PPT headers) must
   decode to its hashes and, through the CLI with ``WSI_READER`` unset,
   launch the five kernels and find exactly the region run's tiles and
   cells; the ``j2k_sub_*`` goldens (subsampled components: 4:2:0,
   4:2:2, 4 × 4, odd sizes, several tiles, precincts, alpha, JP2) must
   decode to their hashes and those PIL refuses raise naming what they
   use; ``tests/golden/j2k_sub_region.svs`` (the same region at
   compression 33003, its chroma 4:2:0 and 4:2:2 in turn, 9/7 at rate
   60) must decode to its hashes and, through the CLI with
   ``WSI_READER`` unset, launch the five kernels and find the region
   run's cells (within 0.5%, ≥ 99% matched), its level 0 decoded whole
   and run as an ``.npy`` exactly its cells; the ``j2k_ht_*`` goldens
   (HT code-blocks of Part 15: lossless and truncated blocks with their
   SigProp and MagRef passes, 1, 3 and 4 components at 8 to 16 bits, both
   wavelets, tiles, layers, a JP2 file) must decode to their hashes and
   the refused ones (mixed HT, ROI, placeholder passes, malformed blocks)
   raise naming what they use; the lossless
   ``tests/golden/j2k_ht_region.svs`` (the same region, 16 tiles of
   lossless 5/3 HT) must decode to its hashes and, through the CLI with
   ``WSI_READER`` unset, launch the five kernels and find exactly the
   region run's tiles and cells; it prints the HT decode rate in MP/s on
   1 and 4 host threads beside the card's name and power limit, and
   the decoder's
   rate in MP/s on one thread and on the loader's reader threads, for
   the 9/7 tiles and for each kind of the lossless and the subsampled
   SVS, and the runs' pipeline seconds; its JPEG-processes
   step: the golden streams of every JPEG
   process the decoder reads (progressive with complete and incomplete
   scripts, arithmetic, CMYK and YCCK, sampling factors 3 and 4,
   lossless) and the 20 tiles of the committed Aperio SVS
   (``tests/golden/jpeg_region.svs``: compression 7, the same region,
   512² tiles of SOF2, SOF10, SOF9 and 4:1:1 baseline at quality 80 and
   a 2× level) must decode on the card's host to the SHA-256 of the
   pixels PIL decoded, and the streams PIL refuses must raise naming
   what they use (``jpeg_golden.json``); the SVS through the CLI with
   ``WSI_READER`` unset must launch the five kernels and find the cells
   of the JPEG 2000 step's region ``.npy`` run (within 0.5%, ≥ 99%
   matched); its level 0 decoded whole and run as an ``.npy`` must find
   exactly its cells; it prints the decoder's rate in MP/s by process on
   one thread and on the reader threads beside PR 15's and the pipeline
   seconds; two damaged copies of that SVS (``tests/golden/
   jpeg_damage.py``): a tile with a byte of entropy-coded data edited must
   decode to PIL's digest (``jpeg_damaged.json``), and the SVS with a
   tile cut by its EOI must stop the CLI with ``RuntimeError("slide
   reader thread failed")`` caused by the decoder's ``ValueError``, as
   PIL's "image file is truncated" stops the JAX reader; its CZI step:
   every JPEG XR golden (``tests/golden/jxr_*.jxr``, written by the
   test-side encoder of ``tests/golden/regenerate_jxr.py``) must decode
   to the SHA-256 of that encoder's pixels (``jxr_golden.json``) and the
   refused ones must raise naming their pixel format and, in the
   codestream, the header field; every CZI golden
   (``tests/golden/czi_*.czi``: overlapping M-indexed tiles at a negative
   origin, box-filtered pyramid layers, two scenes, Bgr48 under Zstd1
   with hi/lo packing, Bgra32, JpgFile, JpgXrFile in Bgr24, Bgr48 and
   Bgra32 and as pyramid layers) must read at every level, on edge
   requests and inside, to the SHA-256 of the JAX ``CZISlide``'s reads
   over the tests' pylibCZIrw fake (``czi_golden.json``), with its MPP,
   and the refused ones (a JpgXr stream cut short, a JpgXr pixel format
   foreign to its pixel type, LZW, camera-specific, Gray8, FilePart 1)
   must raise naming what they use; the committed region CZI
   (``tests/golden/czi_region.czi``: the same region in 16 tiles of 512²,
   8 of them lossless JpgXr in spatial and frequency order at overlap 0,
   1 and 2 with soft and hard tiles, the rest Zstd1, Zstd0 and one
   uncompressed, a pyramid layer at zoom 1/2, MPP 0.4 in its metadata)
   must read at level 0 to the region exactly, and run through the CLI
   with ``WSI_READER=czi`` must launch the five kernels and find exactly
   the tiles and cells of the JPEG 2000 step's region ``.npy`` run
   (matched share 1.0: the subblocks are lossless); it prints the JPEG XR
   decoder's rate in MP/s and the zstd decoder's in MB/s on one thread
   and on the reader threads and both runs'
   pipeline seconds; then
   the GrandQC phase: a tissue (2 classes) and an
   artefact (8 classes) UNet++ of seeded random weights in the smp
   layout, the tissue head's bias set once by rule (``run_grandqc``'s
   docstring), written as ``.pt`` and converted by
   ``classpose-convert-weights-torch --kind grandqc --strict``; the WSI
   CLI on the ``.npy`` slide with both models, ``--filter_artefacts`` and
   ``--min_area`` (QuPath's call): the five kernels must run, the tissue
   pre-filter keep more than 0 and fewer than all 25 tiles, the QC
   GeoJSONs, CSV and store parse (with their tissue and artefact
   groups), and the plain WSI run's cells, filtered on the host by this
   run's tissue and artefact polygons, must be this run's (counts within
   0.5%, ≥ 99% matched); the nets' argmax on the card must agree with
   the same nets on the CPU in ≥ 99.9% of pixels (the tissue thumbnail
   and the first 4 artefact patches); it prints the seconds of the
   thumbnails, the JPEG simulation, both forwards and the contours, the
   UNet++ rate at batch 8, the tissue share and the artefact class
   histogram, and the QC run's pipeline seconds beside the plain run's;
7. runs the evaluate CLI (``entrypoints.run_inference.main_with_args``)
   at fp32 on 2 RGB images of 448² (3 × 3 crops each) written as
   ``images.npy`` with their design-field ``labels.npy``, with the WSI
   phase's ViT-L checkpoint: checks that ``predictions.npy`` and
   ``metrics.csv`` parse, that the PQ table is printed, that the
   head-major attention ran 24 times per crop chunk, that the QC took the
   halo-blocked diffusion and not kernel 4, and that the sampler and
   histogram ran; a run with the plain versions swapped in must give the
   same masks; the metrics CLI (``calculate_metrics.main_with_args``) on
   the outputs must reproduce the evaluate CLI's numbers; then
   ``ClassposeModel.eval`` on one 448² image under the profiler, on one
   256² image (kernel 4, not kernel 7), and ``eval(do_3D=True)`` in bf16
   on a 16 × 32 × 32 stack (kernel 1), compared with the plain
   versions; then the paper's semantic Cellpose-SAM baseline
   (``classpose_tpu_torch.paper_experiments.run_cellpose_semantic.main``)
   at full ViT-L width and fp32: ``--pretrained`` the WSI phase's
   ``conic.pt`` (6 classes) grafted to 7 classes, two epochs on 8 seeded
   disc images of 256² with (H, W, 2) labels (4 steps at batch 4, the
   second epoch's at a learning rate above 0: flow targets by kernel
   4), then the evaluate images as uint8 with
   ``--training_to_inference_mpp 0.25:0.5`` (each read at 224²); then
   ``main --skip_training`` on the donor's weights with the class head
   that training learned (the trained net draws no cells: a step at a
   learning rate above 0 moves the structured donor's blocks off the
   exact cancellations its field rests on). Every launch count is reset
   just before the first call and read just after the second: kernels
   2, 3, 4, 7 and 8 must run (8 on 24 blocks of each image's one crop in
   each call); both calls' predictions must be object arrays of the
   images' (448, 448, 2) maps, the trainer must have written
   ``checkpoint_last.train`` and a class head other than the donor's
   graft, and the second call's maps must hold the design field's
   cells, the same masks and classes as that model run through the
   script's ``predict`` with the plain versions swapped in (worst IoU
   1.0), and other classes than the bare graft gives on the same
   masks; it prints the training imgs/s between steps of one epoch (the
   trainer's wall, its warm-up and checkpoint writes included, apart),
   the peak memory, the eval images/s and the phase's seconds beside the
   card's name and power limit;
   then ``eval`` with a ViT-L at bsize 224 (28 × 28 tokens) on
   one 480² image in fp32 and bf16, against the plain versions, and with
   a ViT-L at bsize 1024 (128 × 128 tokens, L = 16384) on one 1024² image
   in fp32 and bf16 against the plain versions run one head at a time,
   and one kernel-route train step at batch 1 of a 1024² crop;
8. under ``--ab`` only, the A/B of ``ab_attention.py``: kernels 1, 8
   (fp32 and bf16), 5, 2, 3 (also on step 4's input), 4 and 7 at the
   main paths' shapes, the bodies of
   commit ``AB_PARENT`` (``_archive/<AB_PARENT>``, or ``git archive`` of
   it; raises when neither gives them) and the package's timed in turns
   in this process. It is not part of the default run because a checkout
   need not hold the repository's history;
9. prints one JSON line describing the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Any failure raises, so the exit code is not 0 and the last line is not
printed. Without CUDA, or without the rest of the repository beside it,
it fails before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import gc
import hashlib
import io
import json
import logging
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from ab_attention import (
    BUILD,
    KERNEL7_SHAPES,
    PEAK_BF16,
    PEAK_FP32,
    bincount_yardstick,
    bound_ms,
    converged_landing,
    design_labels,
    diffusion_ops,
    grid_sample_yardstick,
    kernel7_inputs,
    parent_sources,
    positions,
    run_ab,
    sdpa_yardstick,
    spread,
    time_ms,
    time_runs,
    uniform_landing,
)
import classpose_tpu_torch.dynamics.flows as port_flows
import classpose_tpu_torch.dynamics.masks as port_masks
import classpose_tpu_torch.nn.layernorm as port_ln
import classpose_tpu_torch.nn.vit_sam as port_vit
import classpose_tpu_torch.train.train as port_train
from classpose_tpu_torch import _build
from classpose_tpu_torch.entrypoints.calculate_metrics import (
    main_with_args as metrics_cli,
)
from classpose_tpu_torch.entrypoints.dataset_to_hdf5 import (
    main_with_args as dataset_to_hdf5_main,
)
from classpose_tpu_torch.entrypoints.convert_weights import (
    main_with_args as convert_cli,
)
from classpose_tpu_torch.entrypoints.parity_check import (
    main_with_args as parity_cli,
)
from classpose_tpu_torch.entrypoints.predict_wsi import (
    build_parser as wsi_parser,
    main_with_args,
)
from classpose_tpu_torch.entrypoints.run_training import (
    main_with_args as run_training_main,
)
from classpose_tpu_torch.entrypoints.run_inference import (
    main_with_args as evaluate_cli,
)
from classpose_tpu_torch.nn.attention import (
    _fwd_kernel,
    attention_relpos,
    attention_relpos_bwd,
    attention_relpos_bwd_plain,
    attention_relpos_plain,
    attention_relpos_plain_route,
    flash_attention_relpos,
    flash_attention_relpos_plain,
)
from classpose_tpu_torch.grandqc import helpers as qc_helpers
from classpose_tpu_torch.grandqc.artefact import (
    MIN_TISSUE_PIXELS,
    MPP_ARTEFACT_MODEL,
)
from classpose_tpu_torch.grandqc.tissue import (
    MPP_TISSUE_MODEL,
    load_unetpp,
    make_unetpp_predict_fn,
    unetpp_logits,
)
from classpose_tpu_torch.io import (
    TiffSlide,
    hdf5,
    jpeg,
    jpeg2000,
    jpegxr,
    zstd,
)
from classpose_tpu_torch.io.czi import JPGXR, ZSTD0, ZSTD1, CziFile
from classpose_tpu_torch.io.czi_reader import CZISlide
from classpose_tpu_torch.io.array_reader import ArraySlide, synthetic_wsi
from classpose_tpu_torch.io.tiff_writer import write_tiled_tiff
from classpose_tpu_torch.io.zarrlite import read_zarr_array
from classpose_tpu_torch.model_configs import (
    DEFAULT_MODEL_CONFIGS,
    resolve_model_config,
)
from classpose_tpu_torch.nn.convert import (
    load_checkpoint,
    published_names,
    save_params,
)
from classpose_tpu_torch.nn.layernorm import layernorm, layernorm_cuda, \
    layernorm_ref
from classpose_tpu_torch.geometry import Polygon, STRtree
from classpose_tpu_torch.grandqc.nets import UnetPlusPlus, UnetPlusPlusConfig
from classpose_tpu_torch.nn.manifest import (
    grandqc_manifest,
    manifest_diff,
    vit_l_manifest,
)
from classpose_tpu_torch.nn.synthetic import (
    PERIOD,
    RADIUS,
    perturbed_structured_params,
    structured_params,
)
from classpose_tpu_torch.nn.vit_sam import ClassTransformerConfig
from classpose_tpu_torch.ops.diffusion import (
    WINDOWS,
    diffuse_blocked,
    diffuse_blocked_plain,
    diffuse_counts,
    diffuse_counts_plain,
    diffusion_plan,
    masked_diffusion,
    masked_diffusion_plain,
    resident_diffusion_supported,
)
from classpose_tpu_torch.ops.sample import (
    bilinear_sample,
    bilinear_sample_plain,
    landing_histogram,
    landing_histogram_plain,
)
from classpose_tpu_torch.ops.tiles import compute_tile_grid
from classpose_tpu_torch.transforms.cvlite import resize_nearest
from classpose_tpu_torch.paper_experiments.run_cellpose_semantic import (
    main as semantic_main,
    predict as semantic_predict,
    semantic_head,
)
from classpose_tpu_torch.parallel.distributed import (
    setup_distributed,
    teardown_distributed,
)
from classpose_tpu_torch.pipeline.outputs import filter_cells_by_tree
from classpose_tpu_torch.pipeline.predict_wsi import (
    build_model_from_config,
    main as wsi_main,
)
from classpose_tpu_torch.pipeline.slide_loader import SlideLoader
from classpose_tpu_torch.runner import ClassposeModel
from classpose_tpu_torch.runner.core import chunk_plan
from classpose_tpu_torch.train.dataset import (
    ClassposeHDF5Dataset,
    ClassposeTrainingDataset,
)
from classpose_tpu_torch.train.train import (
    make_optimizer,
    make_train_step,
    train_class_seg,
)
from classpose_tpu_torch.train.train_utils import process_train_test
from classpose_tpu_torch.transforms import (
    AdditiveNoiseTransform,
    GaussianBlurTransform,
    HEDTransform,
    HEStainingTransform,
    HueBrightnessSaturationTransform,
)
from classpose_tpu_torch.utils import get_slide_resolution

T_START = time.perf_counter()   # the script's wall runs from here
SEED = 0
N_TILES, TILE = 8, 1024
# kernels of the eval_batch path (phase 4); the attention backward runs in
# training only (phase 5), the LayerNorm kernel with its switch on (phase 4's
# second run and the WSI phase)
EVAL_KERNELS = ("attention_fwd", "bilinear_sample", "landing_histogram",
                "masked_diffusion")
WSI_KERNELS = EVAL_KERNELS + ("layernorm",)
LN_SWITCH = "CLASSPOSE_LN_PALLAS"
# the WSI slide: 6144² at 0.4 µm/px, read in 1280² tiles with 80 px overlap
# and resized to 1024² at the config's 0.5 µm/px → a 5×5 grid of tiles
# covering 4864² model pixels
WSI_SIZE, WSI_MPP, WSI_MODEL_MPP = 6144, 0.4, 0.5
# the slide phase: that slide as a tiled-JPEG SVS at the writer's defaults
# (512² tiles, quality 80: 144 tiles at level 0), and the golden stream
SVS_TILE, SVS_QUALITY = 512, 80
GOLDEN = Path(__file__).resolve().parent / "tests" / "golden"
# its JPEG 2000 step: the committed Aperio SVS (compression 33005, 16 tiles
# of 512² at rate 60) of the slide's [0:2048, 0:2048] region, and the PIL
# hashes of it and of the golden codestreams (tests/golden/regenerate_j2k.py)
J2K_SVS, J2K_JSON = GOLDEN / "j2k_region.svs", GOLDEN / "j2k_golden.json"
# and the lossless Aperio SVS of the same region whose 16 tiles are, in
# turn, 12-bit, JP2-boxed, with PPM and with PPT headers, beside the
# j2k_ext_* goldens (decoded) and refused streams (raising by name)
J2K_EXT_SVS = GOLDEN / "j2k_ext_region.svs"
# and the Aperio SVS of the same region at compression 33003 whose 16
# tiles hold Y, Cb and Cr as plain components, the chroma subsampled
# 4:2:0 and 4:2:2 in turn, beside the j2k_sub_* goldens (decoded) and
# refused streams (raising by name)
J2K_SUB_SVS = GOLDEN / "j2k_sub_region.svs"
# and the lossless Aperio SVS of the same region (compression 33005) whose
# 16 tiles hold HT code-blocks (Part 15), beside the j2k_ht_* goldens
# (decoded) and refused streams (raising by name)
J2K_HT_SVS = GOLDEN / "j2k_ht_region.svs"
# its runs read 512² model tiles: a 3×3 grid over the region (at the WSI
# phase's 1024² the region holds one tile)
J2K_MODEL_TILE = 512
# its JPEG-processes step: the committed Aperio SVS (compression 7) of the
# same region, 16 tiles of 512² whose processes are SOF2, SOF10, SOF9 and
# 4:1:1 baseline, the golden streams of every process the decoder reads
# and the refused ones (tests/golden/regenerate_jpeg.py), and the times
# each tile is decoded for its rate
JPEG_SVS, JPEG_JSON = GOLDEN / "jpeg_region.svs", GOLDEN / "jpeg_golden.json"
JPEG_RATE_REPEATS = 8
# its CZI step: the committed Zeiss CZI of the same region
# (tests/golden/regenerate_czi.py: 16 tiles of 512², 8 lossless JpgXr, the
# rest Zstd1, Zstd0 and one uncompressed, a pyramid layer at zoom 1/2, MPP
# 0.4 in its metadata) and the hashes of the JAX reader's reads of every
# CZI golden; the times each zstd and JpgXr subblock is decoded for the
# decoders' rates; the JPEG XR goldens and the hashes of the pixels of the
# encoder that wrote them (tests/golden/regenerate_jxr.py)
CZI_REGION, CZI_JSON = GOLDEN / "czi_region.czi", GOLDEN / "czi_golden.json"
CZI_RATE_REPEATS = 8
JXR_JSON = GOLDEN / "jxr_golden.json"
# its damaged copies of that SVS (tests/golden/jpeg_damage.py): one tile
# cut by its EOI, one tile with a byte of entropy-coded data edited, and
# PIL's digest of the edited tile
JPEG_DAMAGED_JSON = GOLDEN / "jpeg_damaged.json"
# the decoder's rates in PR 15's proof run on these tiles (H100 80GB HBM3
# host at 700 W; MP/s on 1 thread, then on the reader threads); SOF0 is
# the slide step's own baseline SVS
PR15_DECODE_RATES = {"SOF0": (70.61, 242.45), "SOF2": (57.56, 166.70),
                     "SOF10": (29.14, 94.12), "SOF9": (28.41, 109.55),
                     "SOF0 4:1:1": (50.71, 210.03)}
# the training phase's reader step: the committed training set written by
# h5py past its defaults (tests/golden/regenerate_hdf5.py: libver
# "latest", fixed-array and extensible-array chunk indexes, shuffle,
# deflate, fletcher32, lzf, szip, a compact and a big-endian dataset,
# dense links) with h5py's digests, and the train steps taken on it
H5_GOLDEN, H5_JSON = GOLDEN / "hdf5_latest.h5", GOLDEN / "hdf5_golden.json"
H5_BATCH, H5_STEPS = 2, 2
# and the smaller goldens under its "more", the train steps repeated on
# the one at h5py's defaults (its arrays named by soft links)
H5_DEFAULT = GOLDEN / "hdf5_default.h5"
# the GrandQC phase: the QC run's --min_area (µm²; 100 px at MPP 10), the
# artefact patches also run on the CPU, and the batch its rate is timed at
GRANDQC_MIN_AREA, GRANDQC_CPU_PATCHES, GRANDQC_BATCH = 10000, 4, 8
TRAIN_BATCH, TRAIN_IMAGES, TRAIN_SIZE = 8, 16, 512
# the training CLI phase: its epochs and batch, the calls each transform
# is timed over, and the dataset items timed as one batch
CLI_EPOCHS, CLI_BATCH, AUG_CALLS, AUG_ITEMS = 2, 4, 5, 4
# the evaluate phase: RGB images of 448² (3 × 3 crops of 256² each;
# 448 % 128 != 0, so the QC diffusion takes kernel 7), fp32 as the CLI
# defaults: 8 for the kernel checks at the path's shapes, 2 through the
# evaluate CLI (cut from 8, then 4, to keep the script within its budget);
# its kernels, and those of eval's 3D branch in bf16 on a stack cut from
# 16 × 64 × 64 for the same reason
EVAL_IMAGES, EVAL_SIZE, EVAL_BATCH = 8, 448, 8
EVAL_CLI_IMAGES = 2
EVALUATE_KERNELS = ("flash_attention_relpos", "bilinear_sample",
                    "landing_histogram", "diffuse_blocked")
STACK_SHAPE = (16, 32, 32)  # 16 + 32 + 32 slices, one 256² tile each
# fault 3: token grids off the 32 x 32 of bsize 256 (bsize 224 and 512 at
# patch 8, and a non-square one), and the end-to-end checks at bsize 224
# (28 x 28 tokens, L = 784): eval on one image of 480², whose 3 x 3 crop
# origins (0, 128, 256) fall on the design field's period, and a train step
FAULT3_GRIDS = ((28, 28), (64, 64), (12, 20), (8, 128), (128, 128))
FAULT3_BSIZE, FAULT3_SIZE = 224, 480
# the largest crop the kernels take (H + W = 256): bsize 1024 at patch 8,
# 128 x 128 tokens (L = 16384), one WSI tile; eval on one 1024² image
BIG_BSIZE, BIG_SIZE = 1024, 1024
# the commit whose kernel bodies the A/B phase (``--ab``) holds the
# working tree's against
AB_PARENT = "5846458"
# the several-ranks phase: two ranks replay the first 2 epochs of phase
# 5's trainer run (2 steps each at global batch 8, 4 images a rank; epoch
# 0's learning rate is 0, epoch 1's moves the weights); seconds a rank
# may wait in a collective, and the phase's limit; the step totals' limit
# against the one-process run (its bf16 steps sum the two shares'
# gradients in another order: ~4e-6 apart on an H100)
RANKS, RANK_EPOCHS, RANK_COLLECTIVE_S, RANKS_LIMIT_S = 2, 2, 300, 480
RANK_LOSS_RTOL = 1e-4
# the ranks' depth (cut from 24 to keep the script within its budget) and
# that of the one-process run they are held to
RANK_DEPTH = 4
# the semantic baseline phase: the donor is the WSI phase's published
# conic.pt (6 classes), grafted to Lizard's 6 classes plus background;
# seeded disc images with (H, W, 2) labels for two epochs at the script's
# batch 4 (epoch 0's learning rate is 0), then the evaluate phase's two
# 448² design images as uint8, rescaled 0.25 → 0.5 µm/px (exactly 2×
# down) and the maps back
SEM_CLASSES, SEM_TRAIN, SEM_TRAIN_SIZE, SEM_SPEC = 7, 8, 256, "0.25:0.5"
SEM_EPOCHS = 2
SEM_KERNELS = ("masked_diffusion", "flash_attention_relpos",
               "bilinear_sample", "landing_histogram", "diffuse_blocked")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def attention_rates(ms: float, flops: float, bound: float) -> dict:
    """Achieved TFLOP/s at the standard count and share of the bound."""
    return dict(tflops=flops / ms / 1e9, bound_share=bound / ms)


@contextlib.contextmanager
def ln_switch(on: bool):
    """``CLASSPOSE_LN_PALLAS`` set to 1 (the LayerNorm kernel) or 0 (its
    plain version) inside the block, restored after."""
    saved = os.environ.get(LN_SWITCH)
    os.environ[LN_SWITCH] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(LN_SWITCH)
        else:
            os.environ[LN_SWITCH] = saved


# ---------------------------------------------------------------- phase 3

def check_attention(gen, dev) -> dict:
    """Kernel 1 at the inference shape (25 crops × 16 heads × 1024 × 64)
    against its plain version, |Δ| ≤ 1e-2 + 1e-2·|ref|; at the training
    shape (8 crops) its row log-sum-exp against the plain fp32 logits'
    (|Δ| ≤ 1e-3 + 1e-4·|lse|) and its fp32 output against the plain fp32
    softmax product (1e-2 + 1e-2·|ref|). Yardstick: the fastest SDPA
    backend that takes the materialized float bias."""
    B, n, L, hd, G = 25, 16, 1024, 64, 32
    qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    rel = torch.randn(B, L, n, 2 * G, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = hd ** -0.5
    got = attention_relpos(qkv, rel, scale, (G, G), n)
    ref = attention_relpos_plain(qkv, rel, scale, (G, G), n)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    # bf16 output: the kernel rounds unnormalized probabilities to bf16,
    # the plain version normalized ones; both round the output to bf16
    tol = 1e-2 + 1e-2 * ref.float().abs()
    if not bool((err <= tol).all()):
        raise AssertionError(f"attention max|Δ| {float(err.max())}")
    stats = check_attention_stats(qkv[:TRAIN_BATCH], rel[:TRAIN_BATCH],
                                  scale, G, n)
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].reshape(B, L, n, hd)
               .transpose(1, 2).contiguous() for i in range(3))
    mask = (rel[..., :G].transpose(1, 2)[..., :, None]
            + rel[..., G:].transpose(1, 2)[..., None, :]).reshape(B, n, L, L)
    nbytes = (qkv.numel() + rel.numel() + got.numel()) * 2
    flops = 4.0 * B * n * L * L * hd
    b, by = bound_ms(nbytes, flops, PEAK_BF16)
    ms = time_ms(lambda: attention_relpos(qkv, rel, scale, (G, G), n), 10,
                 5)
    res = dict(
        name="attention_fwd", route="cuda",
        source="classpose_tpu_torch/csrc/attention.cu",
        replaces="classpose_tpu/nn/attention.py:404",
        max_abs_err=float(err.max()), ms=ms,
        plain_ms=time_ms(
            lambda: attention_relpos_plain(qkv, rel, scale, (G, G), n), 3),
        bound_ms=b, bound_by=by, **attention_rates(ms, flops, b), **stats,
        **sdpa_yardstick(q, k, v, mask, scale))
    del mask
    return res


def check_attention_stats(qkv, rel, scale, G, n) -> dict:
    """The forward's statistics for the backward at the training shape:
    natural-log lse and the fp32 output, against the plain fp32 logits
    and softmax product; their max |Δ|."""
    B, L, _ = qkv.shape
    hd = qkv.shape[-1] // (3 * n)
    out, lse, out32 = _fwd_kernel(qkv, rel, scale, (G, G), n, True)
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].float()
               .reshape(B, L, n, hd).transpose(1, 2) for i in range(3))
    s = q @ k.transpose(-1, -2) * scale + (
        rel[..., :G].float().transpose(1, 2)[..., :, None]
        + rel[..., G:].float().transpose(1, 2)[..., None, :]
    ).reshape(B, n, L, L)
    lse_ref = torch.logsumexp(s, -1)
    o_ref = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(B, L, n * hd)
    del s
    lse_err = (lse - lse_ref).abs()
    o_err = (out32 - o_ref).abs()
    if not bool((lse_err <= 1e-3 + 1e-4 * lse_ref.abs()).all()):
        raise AssertionError(f"attention lse max|Δ| {float(lse_err.max())}")
    if not bool((o_err <= 1e-2 + 1e-2 * o_ref.abs()).all()):
        raise AssertionError(f"attention out32 max|Δ| {float(o_err.max())}")
    if not torch.equal(out32.bfloat16(), out):
        raise AssertionError("attention out32 does not round to out")
    return dict(lse_max_abs_err=float(lse_err.max()),
                out32_max_abs_err=float(o_err.max()))


def check_attention_bwd(gen, dev) -> dict:
    B, n, L, hd, G = TRAIN_BATCH, 16, 1024, 64, 32
    qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    rel = torch.randn(B, L, n, 2 * G, generator=gen, device=dev).to(
        torch.bfloat16)
    dout = torch.randn(B, L, n * hd, generator=gen, device=dev).to(
        torch.bfloat16)
    scale = hd ** -0.5
    _, lse, out32 = _fwd_kernel(qkv, rel, scale, (G, G), n, True)

    def kernel():
        return attention_relpos_bwd(qkv, rel, out32, lse, dout, scale,
                                    (G, G), n)

    got = kernel()
    ref = attention_relpos_bwd_plain(qkv, rel, dout, scale, (G, G), n)
    torch.cuda.synchronize()
    # bf16 outputs of bf16 products with fp32 sums: the kernel rounds p
    # and ds to bf16 before the products (as the TPU kernel does), the
    # plain version keeps them fp32; both round the result to bf16
    errs = []
    for a, r in zip(got, ref):
        a, r = a.float(), r.float()
        err = (a - r).abs()
        if not bool((err <= 2e-2 * r.abs().max() + 2e-2 * r.abs()).all()):
            raise AssertionError(f"attention bwd max|Δ| {float(err.max())} "
                                 f"of max|ref| {float(r.abs().max())}")
        errs.append(float(err.max()))
    # yardstick: SDPA's backward with a materialized bias that requires
    # grad, with respect to q, k, v and the two bias terms
    q, k, v = (qkv[..., i * n * hd:(i + 1) * n * hd].reshape(B, L, n, hd)
               .transpose(1, 2).contiguous().requires_grad_()
               for i in range(3))
    rh = rel[..., :G].transpose(1, 2).contiguous().requires_grad_()
    rw = rel[..., G:].transpose(1, 2).contiguous().requires_grad_()
    mask = (rh[..., :, None] + rw[..., None, :]).reshape(B, n, L, L)
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
    do = dout.reshape(B, L, n, hd).transpose(1, 2)
    # read qkv, rel, dout (bf16), out32, lse (f32); write dqkv, drel (bf16)
    nbytes = (2 * (qkv.numel() + rel.numel() + dout.numel())
              + 4 * (out32.numel() + lse.numel())
              + 2 * (qkv.numel() + rel.numel()))
    b, by = bound_ms(nbytes, 10.0 * B * n * L * L * hd, PEAK_BF16)
    return dict(
        name="attention_bwd", route="cuda",
        source="classpose_tpu_torch/csrc/attention_bwd.cu",
        replaces="classpose_tpu/nn/attention.py:540",
        max_abs_err=max(errs),
        ms=time_ms(kernel),
        plain_ms=time_ms(lambda: attention_relpos_bwd_plain(
            qkv, rel, dout, scale, (G, G), n), 3),
        library_ms=time_ms(lambda: torch.autograd.grad(
            o, (q, k, v, rh, rw), do, retain_graph=True)),
        bound_ms=b, bound_by=by,
    )


def check_sampler(gen, dev) -> dict:
    B, C, H, W = N_TILES, 2, TILE, TILE
    u = (torch.randn(B, C, H, W, generator=gen, device=dev) * 2).contiguous()
    py, px = positions(gen, dev, 20.0, N_TILES, TILE, TILE)
    got = bilinear_sample(u, py, px)
    ref = bilinear_sample_plain(u, py, px)
    err2 = float((got - ref).abs().max())
    if err2 > 1e-6:
        raise AssertionError(f"sampler C=2 max|Δ| {err2}")
    # C=1 at integer positions (the label lookup) must be exact
    lab = torch.randint(0, 5000, (B, 1, H, W), generator=gen,
                        device=dev).float()
    fy, fx = torch.round(py), torch.round(px)
    g1 = bilinear_sample(lab, fy, fx)
    exact = torch.gather(lab.reshape(B, 1, -1), 2,
                         (fy * W + fx).long().reshape(B, 1, -1))
    if not torch.equal(g1.reshape(B, 1, -1), exact) or not torch.equal(
            g1, bilinear_sample_plain(lab, fy, fx)):
        raise AssertionError("sampler C=1 at integer positions not exact")
    npx = B * H * W
    b, by = bound_ms(npx * (2 * C * 4 + 2 * 4), npx * (6 * C + 4),
                     PEAK_FP32)
    # kernel and yardstick (grid_sample) alike: 15 timings of 3 calls,
    # with the spread
    return dict(
        name="bilinear_sample", route="cuda",
        source="classpose_tpu_torch/csrc/sample.cu",
        replaces="classpose_tpu/ops/sample_pallas.py:297",
        max_abs_err=err2,
        **spread("", time_runs(lambda: bilinear_sample(u, py, px), 15, 3)),
        plain_ms=time_ms(lambda: bilinear_sample_plain(u, py, px)),
        **grid_sample_yardstick(u, py, px),
        bound_ms=b, bound_by=by,
    )


def histogram_timing(fy, fx, cell) -> dict:
    """Kernel 3 on one input against its plain version (bitwise), timed
    (15 timings of 3 calls, with the spread) beside ``bincount``, with
    what the input holds: its counted pixels, the bins they land on and
    the most pixels on one bin."""
    got = landing_histogram(fy, fx, cell)
    ref = landing_histogram_plain(fy, fx, cell)
    if not torch.equal(got, ref):
        raise AssertionError("histogram not exact")
    # read fy, fx, cell once and write the bins once; one add per counted
    # pixel
    b, by = bound_ms(fy.numel() * 16, float(cell.sum()), PEAK_FP32)
    return dict(
        max_abs_err=float((got - ref).abs().max()),
        **spread("", time_runs(lambda: landing_histogram(fy, fx, cell), 15,
                               3)),
        plain_ms=time_ms(lambda: landing_histogram_plain(fy, fx, cell)),
        **bincount_yardstick(fy, fx, cell),
        bound_ms=b, bound_by=by, counted=float(cell.sum()),
        bins=int((ref > 0).sum()), most_on_one_bin=float(ref.max()))


def check_histogram(gen, dev) -> dict:
    """Kernel 3 at 8 × 1024² on two inputs: uniform (each pixel lands
    within ±8 px of itself) and converged (every foreground pixel of the
    design field on its cell's centre, as the masks path's flow steps
    leave them: the line's numbers); see :func:`histogram_timing`."""
    inputs = dict(uniform=uniform_landing(gen, dev, N_TILES, TILE, TILE),
                  converged=converged_landing(dev, N_TILES, TILE, TILE))
    res = {name: histogram_timing(*args) for name, args in inputs.items()}
    line = res["converged"]
    return dict(
        name="landing_histogram", route="cuda",
        source="classpose_tpu_torch/csrc/sample.cu",
        replaces="classpose_tpu/ops/sample_pallas.py:496",
        max_abs_err=max(r["max_abs_err"] for r in res.values()),
        **{k: line[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        inputs=res,
    )


def launches_of(name: str, fn):
    """``fn()`` and the launches of kernel ``name`` it made."""
    before = _build.LAUNCHES[name]
    out = fn()
    return out, _build.LAUNCHES[name] - before


def check_diffusion(dev) -> dict:
    """Kernel 4 against its plain version, bitwise: the QC call of one
    8-tile batch (8 × 1024² of the design field, counts 40/80/120: the
    line's numbers, with its launches per call) and one training target
    (a 512² image at 1200 iterations, ``dynamics/flows.py``'s count for
    targets: its time and launches in ``target_512``)."""
    ids, cen = design_labels(dev, N_TILES, TILE, TILE)
    niter = torch.tensor([40, 80, 120, 40, 80, 120, 40, 80],
                         dtype=torch.int32, device=dev)
    got, per_call = launches_of(
        "masked_diffusion", lambda: masked_diffusion(ids, cen, niter))
    ref = masked_diffusion_plain(ids, cen, niter)
    if not torch.equal(got, ref):
        raise AssertionError("diffusion not bitwise equal to plain")
    i1, c1 = design_labels(dev, 1, TRAIN_SIZE, TRAIN_SIZE)
    n1 = torch.tensor([1200], dtype=torch.int32, device=dev)
    t1, per_target = launches_of(
        "masked_diffusion", lambda: masked_diffusion(i1, c1, n1))
    if not torch.equal(t1, masked_diffusion_plain(i1, c1, n1)):
        raise AssertionError("diffusion at 512²/1200 not bitwise equal")
    b, by = bound_ms(ids.numel() * 12, diffusion_ops(ids, niter), PEAK_FP32)
    b1, _ = bound_ms(i1.numel() * 12, diffusion_ops(i1, n1), PEAK_FP32)
    return dict(
        name="masked_diffusion", route="cuda",
        source="classpose_tpu_torch/csrc/diffusion.cu",
        replaces="classpose_tpu/ops/diffusion_pallas.py:289",
        max_abs_err=float((got - ref).abs().max()),
        ms=time_ms(lambda: masked_diffusion(ids, cen, niter)),
        plain_ms=time_ms(lambda: masked_diffusion_plain(ids, cen, niter), 3),
        library_ms=None,
        bound_ms=b, bound_by=by, launches_per_call=per_call,
        target_512=dict(niter=1200, launches=per_target, bound_ms=b1,
                        ms=time_ms(lambda: masked_diffusion(i1, c1, n1), 3)),
    )


def check_layernorm(gen, dev) -> dict:
    """Kernel 6 at the blocks' (25, 1024, 1024) shape with the fast
    variance (timed, the line's numbers) and the neck's (25, 32, 32, 256)
    two-pass (checked and timed, in ``neck``), each time per call over 10
    calls back to back; inputs ``normal·3 + 0.5``
    as ``tests/test_layernorm.py`` draws them. Tolerance: bf16 outputs of
    fp32 math summed in another order, |Δ| ≤ 0.06 + 0.02·|ref| (the JAX
    package's kernel test). Also checks that the kernel route raises
    where a gradient would flow through it."""
    errs, times = [], {}
    for shape, fast in (((25, 1024, 1024), True), ((25, 32, 32, 256), False)):
        C = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 3 + 0.5).to(
            torch.bfloat16)
        w = torch.randn(C, generator=gen, device=dev)
        b = torch.randn(C, generator=gen, device=dev)
        got = layernorm_cuda(x, w, b, 1e-6, fast)
        ref = layernorm_ref(x, w, b, 1e-6, fast)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if not bool((err <= 0.06 + 0.02 * ref.float().abs()).all()):
            raise AssertionError(f"layernorm {shape} max|Δ| "
                                 f"{float(err.max())}")
        errs.append(float(err.max()))
        # read x once and write y once (bf16), read the fp32 affine; ~8
        # fp32 operations per element
        b_ms, by = bound_ms(2 * 2 * x.numel() + 2 * 4 * C, 8.0 * x.numel(),
                            PEAK_FP32)
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        times[C] = dict(
            ms=time_ms(lambda: layernorm_cuda(x, w, b, 1e-6, fast),
                       inner=10),
            plain_ms=time_ms(lambda: layernorm_ref(x, w, b, 1e-6, fast),
                             inner=10),
            library_ms=time_ms(lambda: F.layer_norm(x, (C,), wl, bl, 1e-6),
                               inner=10),
            bound_ms=b_ms, bound_by=by, max_abs_err=float(err.max()))
    with ln_switch(True):
        xg = torch.ones(4, 1024, device=dev, dtype=torch.bfloat16,
                        requires_grad=True)
        try:
            layernorm(xg, torch.ones(1024, device=dev),
                      torch.zeros(1024, device=dev))
        except RuntimeError as e:
            if "no backward" not in str(e):
                raise
        else:
            raise AssertionError("LayerNorm kernel route took a tensor "
                                 "that needs a gradient")
    blk = times[1024]
    return dict(
        name="layernorm", route="cuda",
        source="classpose_tpu_torch/csrc/layernorm.cu",
        replaces="classpose_tpu/nn/layernorm.py:109",
        max_abs_err=max(errs), ms=blk["ms"], plain_ms=blk["plain_ms"],
        library_ms=blk["library_ms"], bound_ms=blk["bound_ms"],
        bound_by=blk["bound_by"], neck=times[256],
    )


def check_sampling_shapes(gen, dev) -> dict:
    """Kernels 2 and 3 against their plain versions at the evaluate
    path's 8 × 448², at an odd 300 × 500 and at widths off a multiple of 4
    (the sampler's scalar path): the sampler to 1e-6 at C = 2, bitwise at
    integer positions with C = 1 and C = 2, the histogram bitwise."""
    out = {}
    for B, H, W in ((EVAL_IMAGES, EVAL_SIZE, EVAL_SIZE), (1, 300, 500),
                    (2, 130, 70), (1, 257, 1023)):
        u = (torch.randn(B, 2, H, W, generator=gen, device=dev) * 2
             ).contiguous()
        py, px = positions(gen, dev, 20.0, B, H, W)
        err = float((bilinear_sample(u, py, px)
                     - bilinear_sample_plain(u, py, px)).abs().max())
        fy, fx = torch.round(py), torch.round(px)
        lab = torch.randint(0, 5000, (B, 2, H, W), generator=gen,
                            device=dev).float()
        fyi = fy.to(torch.int32).contiguous()
        fxi = fx.to(torch.int32).contiguous()
        cell = (torch.rand(B, H, W, generator=gen, device=dev) < 0.6).float()
        if err > 1e-6 or not all(torch.equal(
                bilinear_sample(x, fy, fx), bilinear_sample_plain(x, fy, fx))
                for x in (lab[:, :1].contiguous(), lab)) or not torch.equal(
                landing_histogram(fyi, fxi, cell),
                landing_histogram_plain(fyi, fxi, cell)):
            raise AssertionError(f"sampler/histogram at {B}×{H}×{W}: "
                                 f"max|Δ| {err}")
        out[f"{B}x{H}x{W}"] = dict(sampler_max_abs_err=err,
                                   histogram_bitwise=True)
    return out


@contextlib.contextmanager
def no_device_sync():
    """Inside the block, an operation that makes the host wait for the
    device (a count read back with ``.max()``/``int()``) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def check_diffuse_blocked(gen, dev) -> dict:
    """Kernel 7 against its plain version, bitwise, at every shape of
    ``KERNEL7_SHAPES`` (the design field from zero with k = 1, as the
    routed QC and the targets call it), each timed (5 timings of 3 calls
    with the count given from the host, with the spread) with its
    launches per call (checked against ``diffusion_plan``) and its
    window; then from a nonzero start on raw (non-dense) labels with
    k = 40 and counts that are multiples neither of k nor of the
    iterations per launch (and a tile with none). At the evaluate call
    (1 × 448², niter 80: the line's numbers) also the device's busy time
    per call from a trace, and the wall of one ``_diffuse_dyn`` call,
    synced, with an int count (under :func:`no_device_sync`: nothing is
    read back) and with a tensor count (read back)."""
    for hw in ((448, 448), (500, 500), (2048, 2048)):
        if resident_diffusion_supported(*hw):
            raise AssertionError(f"{hw} should fail the residency gate")
    shapes = {}
    for name, B, hw, counts in KERNEL7_SHAPES:
        ids, cen, zero, n, nmax = kernel7_inputs(dev, B, hw, counts)
        got, per_call = launches_of(
            "diffuse_blocked", lambda: diffuse_blocked(zero, ids, cen, n, k=1))
        if not torch.equal(got, diffuse_blocked_plain(zero, ids, cen, n,
                                                      k=1)):
            raise AssertionError(f"diffuse_blocked {name}: not bitwise "
                                 f"equal to plain")
        plan = diffusion_plan(B, *hw, nmax)
        if per_call != plan.launches:
            raise AssertionError(f"diffuse_blocked {name}: {per_call} "
                                 f"launches, plan {plan}")
        # read the ids and the centre, write T (and read a T0 where the
        # caller has one); per iteration and foreground pixel two adds a
        # matching neighbour and a multiply
        b, by = bound_ms(ids.numel() * 12, diffusion_ops(ids, n), PEAK_FP32)
        shapes[name] = dict(
            launches_per_call=per_call, window=WINDOWS[plan.window],
            overlap=plan.overlap, bound_ms=b, bound_by=by,
            **spread("", time_runs(lambda: diffuse_counts(
                ids, cen, n, nmax, "diffuse_blocked"), 5, 3)))
        if name == "eval_1x448_80":
            line_plain_ms = time_ms(
                lambda: diffuse_blocked_plain(zero, ids, cen, n, k=1), 3)
            shapes[name]["device_busy_ms"] = traced(lambda: [
                diffuse_counts(ids, cen, n, nmax, "diffuse_blocked")
                for _ in range(10)])["device_busy_ms"] / 10
            walls = {"int": [], "tensor": []}
            n0 = torch.tensor(counts[0], dtype=torch.int32, device=dev)
            for _ in range(20):
                for kind, count in (("int", counts[0]), ("tensor", n0)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    with (no_device_sync() if kind == "int"
                          else contextlib.nullcontext()):
                        port_flows._diffuse_dyn(ids[0], cen[0], count)
                    torch.cuda.synchronize()
                    walls[kind].append((time.perf_counter() - t0) * 1e3)
            shapes[name].update(
                wall_ms_int_count=statistics.median(walls["int"]),
                wall_ms_tensor_count=statistics.median(walls["tensor"]))
        if name == "qc_8x1024":
            shapes[name]["masked_diffusion_ms"] = time_ms(
                lambda: diffuse_counts(ids, cen, n, nmax, "masked_diffusion"))
    ids, cen = design_labels(dev, EVAL_IMAGES, EVAL_SIZE, EVAL_SIZE)
    T0 = (torch.rand(ids.shape, generator=gen, device=dev) * 2).contiguous()
    raw = (ids * 977).contiguous()
    odd = torch.tensor([13, 50, 0, 41, 79, 7, 120, 1], dtype=torch.int32,
                       device=dev)
    if not torch.equal(diffuse_blocked(T0, raw, cen, odd, k=40),
                       diffuse_blocked_plain(T0, raw, cen, odd, k=40)):
        raise AssertionError("diffuse_blocked from a nonzero start, raw "
                             "labels, k = 40: not bitwise equal to plain")
    line = shapes["eval_1x448_80"]
    return dict(
        name="diffuse_blocked", route="cuda",
        source="classpose_tpu_torch/csrc/diffusion.cu",
        replaces="classpose_tpu/ops/diffusion_pallas.py:143",
        max_abs_err=0.0, ms=line["ms"], plain_ms=line_plain_ms,
        library_ms=None, bound_ms=line["bound_ms"],
        bound_by=line["bound_by"], shapes=shapes,
    )


def check_flash_attention(gen, dev) -> dict:
    """Kernel 8 at the evaluate path's shape (8 crops × 16 heads × 1024
    tokens × 64, rel_h and rel_w (8, 16, 1024, 32)) against its plain
    version: fp32 (the path's dtype; the line's numbers), true fp32
    products, |Δ| ≤ 1e-4 + 1e-4·|ref|; bf16 (in ``bf16``) as kernel 1,
    |Δ| ≤ 1e-2 + 1e-2·|ref|. Yardstick: SDPA with the materialized
    (B, n, L, L) bias in the same dtype. Also checks that the kernel
    route raises where a gradient would flow through it."""
    B, n, L, hd, G = EVAL_BATCH, 16, 1024, 64, 32
    scale = hd ** -0.5
    res = {}
    for dtype, tol, peak in ((torch.float32, 1e-4, PEAK_FP32),
                             (torch.bfloat16, 1e-2, PEAK_BF16)):
        q, k, v = (torch.randn(B, n, L, hd, generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        rh, rw = ((2 * torch.randn(B, n, L, G, generator=gen, device=dev))
                  .to(dtype) for _ in range(2))
        got = flash_attention_relpos(q, k, v, rh, rw, scale, (G, G))
        ref = flash_attention_relpos_plain(q, k, v, rh, rw, scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs()
        if got.dtype != dtype or not bool(
                (err <= tol + tol * ref.float().abs()).all()):
            raise AssertionError(f"flash_attention_relpos {dtype} max|Δ| "
                                 f"{float(err.max())}")
        mask = (rh[..., :, None] + rw[..., None, :]).reshape(B, n, L, L)
        nbytes = (q.numel() * 4 + rh.numel() * 2) * q.element_size()
        b, by = bound_ms(nbytes, 4.0 * B * n * L * L * hd, peak)
        flops = 4.0 * B * n * L * L * hd
        ms = time_ms(lambda: flash_attention_relpos(q, k, v, rh, rw, scale,
                                                    (G, G)), 10, 5)
        res[dtype] = dict(
            max_abs_err=float(err.max()), ms=ms,
            plain_ms=time_ms(lambda: flash_attention_relpos_plain(
                q, k, v, rh, rw, scale), 3),
            bound_ms=b, bound_by=by, **attention_rates(ms, flops, b),
            **sdpa_yardstick(q, k, v, mask, scale))
        del mask
    qg = torch.zeros(1, 1, 64, 64, device=dev, requires_grad=True)
    z = torch.zeros(1, 1, 64, 8, device=dev)
    try:
        flash_attention_relpos(qg, qg, qg, z, z, 0.125, (8, 8))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
    else:
        raise AssertionError("head-major kernel route took a tensor that "
                             "needs a gradient")
    return dict(name="flash_attention_relpos", route="cuda",
                source="classpose_tpu_torch/csrc/attention_hm.cu",
                replaces="classpose_tpu/nn/attention.py:93",
                **res[torch.float32], bf16=res[torch.bfloat16])


def check_fault3_grids(gen, dev) -> dict:
    """Fault 3: the attention kernels at the grids of ``FAULT3_GRIDS``
    (2 crops × 16 heads; at 128 × 128, L = 16384, 1 crop × 2 heads: the
    plain versions' (B, n, L, L) fp32 intermediates) against their plain
    versions at the tolerances of the main-path checks: kernel 1 (bf16,
    1e-2 + 1e-2·|ref|), kernel 8 in fp32 (1e-4 + 1e-4·|ref|) and bf16
    (1e-2 + 1e-2·|ref|), kernel 5 (2e-2·max|ref| + 2e-2·|ref|); each
    kernel's time (CUDA events, 5 × 3 calls) and the shape it ran at."""
    hd = 64
    scale = hd ** -0.5
    out = {}

    def held(got, ref, tol, what):
        err = (got.float() - ref.float()).abs()
        if not bool((err <= tol(ref.float())).all()):
            raise AssertionError(f"{what}: max|Δ| {float(err.max())}")
        return float(err.max())

    for H, W in FAULT3_GRIDS:
        L = H * W
        B, n = (2, 16) if L <= 4096 else (1, 2)
        res = dict(crops=B, heads=n)
        qkv = torch.randn(B, L, 3 * n * hd, generator=gen, device=dev).to(
            torch.bfloat16)
        rel = (2 * torch.randn(B, L, n, H + W, generator=gen, device=dev)
               ).to(torch.bfloat16)
        fwd = lambda: attention_relpos(qkv, rel, scale, (H, W), n)  # noqa
        res["attention_fwd"] = dict(
            max_abs_err=held(fwd(), attention_relpos_plain(
                qkv, rel, scale, (H, W), n), lambda r: 1e-2 + 1e-2 * r.abs(),
                f"kernel 1 at {H}×{W}"),
            ms=time_ms(fwd, 5, 3))
        dout = torch.randn(B, L, n * hd, generator=gen, device=dev).to(
            torch.bfloat16)
        _, lse, out32 = _fwd_kernel(qkv, rel, scale, (H, W), n, True)
        bwd = lambda: attention_relpos_bwd(  # noqa: E731
            qkv, rel, out32, lse, dout, scale, (H, W), n)
        ref = attention_relpos_bwd_plain(qkv, rel, dout, scale, (H, W), n)
        res["attention_bwd"] = dict(
            max_abs_err=max(held(a, r, lambda x: 2e-2 * x.abs().max()
                                 + 2e-2 * x.abs(), f"kernel 5 at {H}×{W}")
                            for a, r in zip(bwd(), ref)),
            ms=time_ms(bwd, 5, 3))
        del ref
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 1e-2)):
            q, k, v = (torch.randn(B, n, L, hd, generator=gen, device=dev)
                       .to(dtype) for _ in range(3))
            rh = (2 * torch.randn(B, n, L, H, generator=gen, device=dev)
                  ).to(dtype)
            rw = (2 * torch.randn(B, n, L, W, generator=gen, device=dev)
                  ).to(dtype)
            hm = lambda: flash_attention_relpos(  # noqa: E731
                q, k, v, rh, rw, scale, (H, W))
            res[f"flash_attention_relpos_{str(dtype)[6:]}"] = dict(
                max_abs_err=held(hm(), flash_attention_relpos_plain(
                    q, k, v, rh, rw, scale), lambda r: tol + tol * r.abs(),
                    f"kernel 8 {dtype} at {H}×{W}"),
                ms=time_ms(hm, 5, 3))
        torch.cuda.synchronize()
        out[f"{H}x{W}"] = res
    return out


# ---------------------------------------------------------------- phase 4

def match_masks(ma: np.ndarray, mb: np.ndarray):
    """Pair instances of two label maps by IoU: [(a, b, iou)]."""
    pairs = []
    fg = ma > 0
    a_ids, b_ids = ma[fg], mb[fg]
    inter = np.bincount(a_ids.astype(np.int64) * (int(mb.max()) + 1) + b_ids,
                        minlength=(int(ma.max()) + 1) * (int(mb.max()) + 1))
    inter = inter.reshape(int(ma.max()) + 1, int(mb.max()) + 1)
    inter[:, 0] = 0
    na, nb = np.bincount(ma.ravel()), np.bincount(mb.ravel())
    for a in range(1, len(na)):
        b = int(inter[a].argmax())
        i = inter[a, b]
        pairs.append((a, b, i / (na[a] + (nb[b] if b else 0) - i)))
    return pairs


def instance_classes(m: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Class of each instance id of label map ``m`` (classes are constant
    per instance)."""
    out = np.zeros(int(m.max()) + 1, np.int64)
    out[m.ravel()] = c.ravel()
    return out


def compare_slices(run, ref) -> float:
    """Mask agreement of two eval_batch results (counts equal, every
    instance matched at IoU ≥ 0.95, ≥ 99.5% pixel agreement, equal
    classes on matched instances); returns the worst IoU."""
    worst = 1.0
    for (m, c), (m_ref, c_ref) in zip(run, ref):
        if m.max() != m_ref.max():
            raise AssertionError(f"instances {m.max()} vs {m_ref.max()}")
        pairs = match_masks(m_ref, m)
        worst = min([worst] + [iou for _, _, iou in pairs])
        if worst < 0.95 or ((m > 0) == (m_ref > 0)).mean() < 0.995:
            raise AssertionError(f"masks disagree (worst IoU {worst})")
        cls, cls_ref = instance_classes(m, c), instance_classes(m_ref, c_ref)
        for a, b, _ in pairs:
            if cls_ref[a] != cls[b]:
                raise AssertionError(f"class of instance {a} differs")
    return worst


def attention_by_head(qkv, rel, scale, grid_hw, num_heads):
    """The plain token-major route one head at a time (the same math per
    head): at L = 16384 a head's (L, L) fp32 logits alone take 1 GiB."""
    hd = qkv.shape[-1] // (3 * num_heads)
    outs = []
    for h in range(num_heads):
        cols = torch.cat([qkv[..., (i * num_heads + h) * hd:
                              (i * num_heads + h + 1) * hd]
                          for i in range(3)], -1).contiguous()
        outs.append(attention_relpos_plain_route(
            cols, rel[:, :, h:h + 1].contiguous(), scale, grid_hw, 1))
    return torch.cat(outs, -1)


def flash_attention_by_head(q, k, v, rh, rw, scale, grid_hw):
    """The plain head-major version one head at a time."""
    return torch.cat([flash_attention_relpos_plain(
        q[:, h:h + 1], k[:, h:h + 1], v[:, h:h + 1], rh[:, h:h + 1],
        rw[:, h:h + 1], scale) for h in range(q.shape[1])], 1)


def plain_versions(by_head: bool = False):
    """Swap the plain versions in where the slices call the kernels (the
    attention through its differentiable plain route; with ``by_head``,
    inference only, one head at a time)."""
    saved = (port_masks.bilinear_sample, port_masks.landing_histogram,
             port_flows.diffuse_counts, port_vit.attention_relpos,
             port_vit.flash_attention_relpos, port_ln.layernorm)
    port_masks.bilinear_sample = bilinear_sample_plain
    port_masks.landing_histogram = landing_histogram_plain
    port_flows.diffuse_counts = diffuse_counts_plain
    port_vit.attention_relpos = (attention_by_head if by_head
                                 else attention_relpos_plain_route)
    port_vit.flash_attention_relpos = (
        flash_attention_by_head if by_head else
        lambda q, k, v, rh, rw, scale, grid_hw:
        flash_attention_relpos_plain(q, k, v, rh, rw, scale))
    port_ln.layernorm = layernorm_ref

    def restore():
        (port_masks.bilinear_sample, port_masks.landing_histogram,
         port_flows.diffuse_counts, port_vit.attention_relpos,
         port_vit.flash_attention_relpos, port_ln.layernorm) = saved

    return restore


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel, by its name."""
    n = name.lower()
    for cls, marks in (("attention kernels", ("attn_",)),
                       ("dynamics kernels", ("bilinear_sample",
                                             "landing_histogram",
                                             "round_kernel",
                                             "pack_kernel")),
                       ("convolution", ("conv", "cudnn", "fprop", "dgrad",
                                        "wgrad")),
                       ("matmul", ("nvjet", "gemm", "cutlass", "xmma")),
                       ("optimizer", ("multi_tensor", "foreach")),
                       ("reductions", ("reduce", "norm")),
                       ("memcpy/memset", ("memcpy", "memset")),
                       ("elementwise", ("elementwise", "functor", "copy"))):
        if any(m in n for m in marks):
            return cls
    return "other"


def traced(fn) -> dict:
    """Run ``fn()`` once under torch.profiler: its wall (synced), the
    device's busy time and idle share, and the device time by kernel and
    by class of kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        traced_wall_s = time.perf_counter() - t0
    rows = []  # device-side kernel and memcpy events only
    for e in prof.key_averages():
        # a record_function range (the optimizer's step) shows on the
        # device timeline too; its kernels are counted on their own
        if e.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        if t > 0:
            rows.append((t / 1e3, e.key, e.count))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    by_class: dict[str, float] = {}
    for t, k, _ in rows:
        by_class[kernel_class(k)] = by_class.get(kernel_class(k), 0.0) + t
    return dict(
        traced_wall_s=traced_wall_s, device_busy_ms=device_ms,
        device_idle_share=1.0 - device_ms / (traced_wall_s * 1e3),
        by_class_ms=dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        top_kernels=[dict(name=k[:80], ms=t, calls=c)
                     for t, k, c in rows[:12]],
    )


def profile_slice(model, tiles, kw) -> dict:
    """Where one batch's time goes: the device program's wall (synced)
    against the whole call's, and the device time by kernel from a
    torch.profiler trace of one more call."""
    x = torch.as_tensor(tiles).to(model.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model._device_program(x, kw["batch_size"], False, kw["niter"], 0.4, 0.0,
                          0.4)
    torch.cuda.synchronize()
    device_program_s = time.perf_counter() - t0
    return dict(device_program_s=device_program_s,
                **traced(lambda: model.eval_batch(tiles, **kw)))


def run_slice(dev) -> tuple[dict, dict, tuple, ClassposeModel]:
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16")
    t0 = time.perf_counter()
    model = ClassposeModel(cfg=cfg, params=structured_params(cfg),
                           precision="bf16", device=dev)
    log(f"model built in {time.perf_counter() - t0:.1f} s "
        f"(depth {cfg.depth}, width {cfg.embed_dim})")
    tiles = np.random.default_rng(SEED).integers(
        0, 256, size=(N_TILES, TILE, TILE, 3), dtype=np.uint8)
    kw = dict(batch_size=32, niter=200)

    def timed_run(ln_on: bool):
        with ln_switch(ln_on):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = model.eval_batch(tiles, **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, dict(_build.LAUNCHES)

    # warm-up (allocator, cuDNN plans), keeping the histogram's input
    landings = []

    def keep_landing(fy, fx, cell):
        landings.append((fy.clone(), fx.clone(), cell.clone()))
        return landing_histogram(fy, fx, cell)

    port_masks.landing_histogram = keep_landing
    try:
        with ln_switch(False):
            model.eval_batch(tiles, **kw)
    finally:
        port_masks.landing_histogram = landing_histogram
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = timed_run(False)
    log(f"main path launches: {launches}")
    missing = [k for k in EVAL_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    counts = [int(m.max()) for m, _ in out]
    for m, c in out:
        if m.shape != (TILE, TILE) or m.dtype != np.int32 \
                or c.shape != m.shape:
            raise AssertionError(f"bad output {m.shape} {m.dtype}")
    if not all(900 <= n <= 1100 for n in counts):
        raise AssertionError(f"instances per tile {counts}, expected ~1024")

    breakdown = profile_slice(model, tiles, kw)
    log(f"breakdown: {json.dumps(breakdown)}")

    restore = plain_versions()
    try:
        t1 = time.perf_counter()
        ref = model.eval_batch(tiles, **kw)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t1
    finally:
        restore()
    worst = compare_slices(out, ref)

    # the LayerNorm switch, in turns on one card: off (above), on, on, off
    out_ln, ln_wall, ln_launches = timed_run(True)
    log(f"LayerNorm kernel launches: {ln_launches}")
    want = N_TILES * 2 * (cfg.depth + 1)  # 2 per block + 2 neck per tile
    if ln_launches["layernorm"] != want or launches["layernorm"] != 0:
        raise AssertionError(f"layernorm launches {ln_launches['layernorm']} "
                             f"with the switch on (want {want}), "
                             f"{launches['layernorm']} with it off")
    ln_worst = compare_slices(out_ln, out)
    ln_wall2 = timed_run(True)[1]
    off_wall2 = timed_run(False)[1]
    stats = dict(
        tiles_per_s=N_TILES / wall, wall_s=wall, plain_wall_s=plain_wall,
        ln_switch_walls_s=dict(off=[wall, off_wall2],
                               on=[ln_wall, ln_wall2]),
        ln_launches=ln_launches["layernorm"], worst_iou_ln_vs_off=ln_worst,
        instances=counts, worst_iou_vs_plain=worst,
        peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        breakdown=breakdown,
        # kernel 3 on this path's own input (one call per batch)
        histogram_on_path=histogram_timing(*landings[-1]),
    )
    return launches, stats, landings[-1], model


def run_fast_qc(dev, model) -> dict:
    """``eval_batch`` with ``--fast_qc``'s settings (``qc_downsample=2``,
    ``percentile_subsample=2``) on phase 4's batch as float tiles, against
    the same call with the plain versions; kernel 4 at the batch's QC
    shape (the labels at every other pixel, one count for the batch),
    captured from the call, against its plain version (see the module
    docstring, step 4)."""
    tiles = np.random.default_rng(SEED).integers(
        0, 256, size=(N_TILES, TILE, TILE, 3)).astype(np.float32)
    kw = dict(batch_size=32, niter=200, qc_downsample=2,
              percentile_subsample=2)
    qc_inputs = []

    def keep_qc(ids, cen, n, nmax=None, kernel="masked_diffusion", T0=None):
        qc_inputs.append((ids.clone(), cen.clone(), n.clone(), nmax))
        return diffuse_counts(ids, cen, n, nmax, kernel, T0)

    port_flows.diffuse_counts = keep_qc
    try:
        model.eval_batch(tiles, **kw)  # warm-up, keeping the QC's input
    finally:
        port_flows.diffuse_counts = diffuse_counts
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    out = model.eval_batch(tiles, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"fast QC launches: {launches}")
    missing = [k for k in EVAL_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched with --fast_qc's "
                             f"settings: {missing}")
    restore = plain_versions()
    try:
        ref = model.eval_batch(tiles, **kw)
    finally:
        restore()
    worst = compare_slices(out, ref)
    if worst != 1.0:
        raise AssertionError(f"fast QC vs plain: worst IoU {worst}")
    t0 = time.perf_counter()
    full = model.eval_batch(tiles, batch_size=32, niter=200)
    torch.cuda.synchronize()
    full_wall = time.perf_counter() - t0

    ids, cen, n, nmax = qc_inputs[-1]
    B, H, W = ids.shape
    got, per_call = launches_of(
        "masked_diffusion",
        lambda: diffuse_counts(ids, cen, n, nmax, "masked_diffusion"))
    if not torch.equal(got, diffuse_counts_plain(ids, cen, n, nmax)):
        raise AssertionError("kernel 4 at the fast QC's shape not bitwise "
                             "equal to plain")
    plan = diffusion_plan(B, H, W, nmax)
    if per_call != plan.launches or nmax is None:
        raise AssertionError(f"fast QC diffusion: {per_call} launches, "
                             f"plan {plan.launches}, count {nmax}")
    b, by = bound_ms(ids.numel() * 12, diffusion_ops(ids, n), PEAK_FP32)
    kernel4 = dict(
        shape=[B, H, W], niter=nmax, launches_per_call=per_call,
        window=WINDOWS[plan.window], bound_ms=b, bound_by=by,
        ms=time_ms(lambda: diffuse_counts(ids, cen, n, nmax,
                                          "masked_diffusion"), 5),
        plain_ms=time_ms(lambda: diffuse_counts_plain(ids, cen, n, nmax), 3),
        launches_in_batch=launches["masked_diffusion"])
    log(f"kernel 4 at the fast QC's shape: {json.dumps(kernel4)}")
    return dict(
        tiles_per_s=N_TILES / wall, wall_s=wall,
        full_fidelity_wall_s=full_wall,
        instances=[int(m.max()) for m, _ in out],
        full_fidelity_instances=[int(m.max()) for m, _ in full],
        worst_iou_vs_plain=worst, launches=launches, kernel4=kernel4)


# ---------------------------------------------------------------- phase 5

def disc_images(rng, n_images: int, size: int, n_discs: int,
                n_classes: int):
    """Synthetic training data: ~``n_discs`` non-overlapping discs per
    image in classes 1..n_classes−1, each class darkening the three
    channels by its own amounts over a noisy background. Returns images
    (3, S, S) float32 and labels (2, S, S) [instance, class]."""
    yy, xx = np.mgrid[:size, :size]
    shade = rng.uniform(20, 90, size=(n_classes, 3))
    images, labels = [], []
    for _ in range(n_images):
        inst = np.zeros((size, size), np.float32)
        cls = np.zeros((size, size), np.float32)
        k = 0
        for _ in range(n_discs):
            r = int(rng.integers(8, 15))
            cy, cx = (int(v) for v in rng.integers(r, size - r, 2))
            win = (slice(cy - r, cy + r + 1), slice(cx - r, cx + r + 1))
            m = (((yy[win] - cy) ** 2 + (xx[win] - cx) ** 2 <= r * r)
                 & (inst[win] == 0))
            if m.sum() < 20:
                continue
            k += 1
            inst[win][m] = k
            cls[win][m] = rng.integers(1, n_classes)
        img = 200 + rng.normal(0, 8, (3, size, size))
        img -= shade[cls.astype(np.int64)].transpose(2, 0, 1) * (inst > 0)
        images.append(img.astype(np.float32))
        labels.append(np.stack([inst, cls]))
    return images, labels


def vit_train_flops_per_image(cfg) -> float:
    """3 × the forward's matmul FLOPs for one bsize² crop (the MFU
    convention of tools/bench_train.py, whose count this repeats)."""
    L = cfg.tokens_hw ** 2
    E, ps, D = cfg.embed_dim, cfg.ps, cfg.neck_dim
    per_tok = 3 * E * E * 2 + E * E * 2 + 2 * E * E * cfg.mlp_ratio * 2
    attn = 2 * L * L * E * 2
    blocks = cfg.depth * (L * per_tok + attn)
    patch = L * (3 * ps * ps) * E * 2
    neck = L * (E * D + 9 * D * D) * 2
    heads = L * D * (3 + cfg.n_cell_classes) * ps * ps * 2
    return 3.0 * (blocks + patch + neck + heads)


def attention_grads_ok(grads: dict, depth: int) -> int:
    """Every attention parameter of every block has a finite gradient of
    non-zero norm (the kernels' backward reached it); returns how many
    were checked."""
    keys = [k for k in grads if ".attn." in k]
    if len(keys) != 6 * depth:
        raise AssertionError(f"{len(keys)} attention parameters")
    for k in keys:
        g = grads[k]
        if not bool(torch.isfinite(g).all()) or float(g.norm()) == 0.0:
            raise AssertionError(f"{k}: gradient not finite or zero")
    return len(keys)


def step_grads(net, X, lbl, cw, n_classes):
    """One train step at learning rate 0 without layer-drop: (total loss,
    every parameter's gradient); the parameters do not move."""
    lv = torch.zeros(3, device=X.device)
    opt = make_optimizer(net, lv, 0.1, None, True)
    step = make_train_step(net, opt, lv, np.zeros(1), n_classes,
                           use_uncertainty_weighting=True,
                           class_weights=cw, rdrop=False)
    total = float(step(X, lbl)["total"])
    return total, {k: p.grad.detach().float().clone()
                   for k, p in net.named_parameters()}


def run_training(dev, out_dir: str) -> tuple[dict, dict, dict]:
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16")
    rng = np.random.default_rng(SEED)
    images, labels = disc_images(rng, TRAIN_IMAGES, TRAIN_SIZE, 60,
                                 cfg.n_cell_classes)
    _build.reset_launches()
    t0 = time.perf_counter()
    tr_d, tr_l, tr_diam, *_ = process_train_test(images, labels, device=dev)
    targets_s = time.perf_counter() - t0
    target_launches = _build.LAUNCHES["masked_diffusion"]
    if target_launches == 0 or len(tr_d) != TRAIN_IMAGES:
        raise AssertionError(f"targets: {len(tr_d)} images, "
                             f"{target_launches} diffusion launches")
    ds = ClassposeTrainingDataset(np.stack(tr_d), np.stack(tr_l),
                                  diameter_array=tr_diam, bsize=cfg.bsize,
                                  seed=SEED)
    cw = ds.class_weights
    model = ClassposeModel(cfg=cfg, precision="bf16", device=dev, seed=SEED)
    net = model.net
    watched = {k: p.detach().clone() for k, p in net.named_parameters()
               if ".attn." in k or k.startswith(("out.", "out_class."))}

    # the trainer: 3 epochs of 2 steps, epoch 0 at lr 0 by the schedule;
    # its items and step losses recorded for the several-ranks phase
    n_epochs, steps = 3, 3 * (TRAIN_IMAGES // TRAIN_BATCH)
    recorded, save_walls = RecordedDataset(ds), []

    def timed_save(*args, **kwargs):
        t = time.perf_counter()
        save_params(*args, **kwargs)
        save_walls.append(time.perf_counter() - t)

    _build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the .npz goes uncompressed, as in every phase: the compressed save
    # was ~70 s of host zlib on the card's host, which no port code runs
    with mock.patch.object(port_train, "save_params", timed_save), \
            mock.patch.object(np, "savez_compressed", np.savez):
        path, train_losses, _ = train_class_seg(
            model, recorded, batch_size=TRAIN_BATCH, n_epochs=n_epochs,
            learning_rate=1e-4, save_path=out_dir, model_name="smoke",
            class_weights=cw, use_uncertainty_weighting=True,
            random_seed=SEED)
    torch.cuda.synchronize()
    trainer_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"training launches: {launches}")
    for k in ("attention_fwd", "attention_bwd"):
        if launches[k] != cfg.depth * steps:
            raise AssertionError(f"{k}: {launches[k]} launches, expected "
                                 f"{cfg.depth} per step × {steps} steps")
    if not np.isfinite(train_losses).all():
        raise AssertionError(f"train losses {train_losses}")
    params = dict(net.named_parameters())
    still = [k for k, v in watched.items() if torch.equal(v, params[k])]
    if still:
        raise AssertionError(f"{len(still)} parameters did not move: "
                             f"{still[:4]}")
    del watched

    # the trainer's host work besides its steps: one batch through the
    # augmentation, and its save of the final weights (timed above)
    t0 = time.perf_counter()
    items = [ds[i] for i in range(TRAIN_BATCH)]
    batch_load_s = time.perf_counter() - t0
    (save_npz_s,) = save_walls

    # the step alone at batch 8: median wall, peak memory, MFU, a trace
    X = torch.from_numpy(np.stack([x for x, _ in items])).to(dev)
    lbl = torch.from_numpy(np.stack([y for _, y in items])).to(dev)
    lv = torch.zeros(3, device=dev)
    opt = make_optimizer(net, lv, 0.1, None, True)
    step = make_train_step(
        net, opt, lv, np.full(1, 1e-5), cfg.n_cell_classes,
        use_uncertainty_weighting=True, class_weights=cw, rdrop=True,
        generator=torch.Generator(device=dev).manual_seed(SEED))
    step(X, lbl)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    times = []
    for _ in range(6):
        t0 = time.perf_counter()
        metrics = step(X, lbl)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    step_launches = {k: v / len(times) for k, v in _build.LAUNCHES.items()}
    if not all(np.isfinite(float(v)) for v in metrics.values()):
        raise AssertionError(f"step metrics {metrics}")
    step_s = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mfu = vit_train_flops_per_image(cfg) * TRAIN_BATCH / step_s / PEAK_BF16
    breakdown = traced(lambda: step(X, lbl))
    log(f"train step breakdown: {json.dumps(breakdown)}")
    del opt, step

    # one step at batch 2 without layer-drop (which may drop a block for
    # every sample), kernels against the plain versions, from the same
    # state and batch
    X2, lbl2 = X[:2].contiguous(), lbl[:2].contiguous()
    total, grads = step_grads(net, X2, lbl2, cw, cfg.n_cell_classes)
    n_attn = attention_grads_ok(grads, cfg.depth)
    restore = plain_versions()
    try:
        total_ref, grads_ref = step_grads(net, X2, lbl2, cw,
                                          cfg.n_cell_classes)
    finally:
        restore()
    # bf16 network, attention rounded differently in the two routes
    if abs(total - total_ref) > 1e-2 * abs(total_ref):
        raise AssertionError(f"step loss {total} vs plain {total_ref}")
    cos = {k: float(F.cosine_similarity(grads[k].flatten(),
                                        grads_ref[k].flatten(), 0))
           for k in grads}
    worst = min(cos, key=cos.get)
    if cos[worst] < 0.99:
        raise AssertionError(f"gradient of {worst}: cosine {cos[worst]} "
                             f"to the plain route's")
    del grads, grads_ref
    fault3 = fault3_train_step(dev, tr_d, tr_l, tr_diam)
    log(f"fault 3 train step: {json.dumps(fault3)}")
    targets = dict(images=np.stack(tr_d), labels=np.stack(tr_l),
                   diameters=np.asarray(tr_diam),
                   class_counts=ds.class_counts,
                   instance_counts=ds.instance_counts,
                   replay=recorded.replay(cw))
    stats = dict(
        targets_s=targets_s, target_diffusion_launches=target_launches,
        trainer_s=trainer_s, batch_load_s=batch_load_s,
        save_npz_s=save_npz_s, train_losses=train_losses.tolist(),
        final_weights=path.split("/")[-1],
        attention_params_checked=n_attn,
        step_batch=TRAIN_BATCH, step_ms_median=step_s * 1e3,
        step_ms_all=[t * 1e3 for t in times], imgs_per_s=TRAIN_BATCH / step_s,
        peak_mem_gib=peak, mfu_3x_fwd=mfu, launches_per_step=step_launches,
        plain_check_loss=[total, total_ref],
        plain_check_min_cosine=[worst, cos[worst]],
        breakdown=breakdown, fault3_step=fault3,
    )
    return launches, stats, targets


def fault3_train_step(dev, tr_d, tr_l, tr_diam) -> dict:
    """Fault 3 in training: one bf16 step at batch 8 of 224² crops (28 × 28
    tokens, L = 784) of the training phase's images, full ViT-L width,
    seeded random weights, without layer-drop; one launch of each
    attention kernel per block; loss within 1e-2 relative and every
    parameter's gradient at cosine ≥ 0.99 against the same step with the
    plain versions swapped in."""
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16",
                                 bsize=FAULT3_BSIZE)
    ds = ClassposeTrainingDataset(np.stack(tr_d), np.stack(tr_l),
                                  diameter_array=tr_diam, bsize=cfg.bsize,
                                  seed=SEED)
    items = [ds[i] for i in range(TRAIN_BATCH)]
    X = torch.from_numpy(np.stack([x for x, _ in items])).to(dev)
    lbl = torch.from_numpy(np.stack([y for _, y in items])).to(dev)
    net = ClassposeModel(cfg=cfg, precision="bf16", device=dev,
                         seed=SEED).net
    torch.cuda.synchronize()
    _build.reset_launches()
    total, grads = step_grads(net, X, lbl, ds.class_weights,
                              cfg.n_cell_classes)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    if any(launches[k] != cfg.depth for k in ("attention_fwd",
                                              "attention_bwd")):
        raise AssertionError(f"224² step launches {launches}")
    restore = plain_versions()
    try:
        total_ref, grads_ref = step_grads(net, X, lbl, ds.class_weights,
                                          cfg.n_cell_classes)
    finally:
        restore()
    if abs(total - total_ref) > 1e-2 * abs(total_ref):
        raise AssertionError(f"224² step loss {total} vs plain {total_ref}")
    cos = {k: float(F.cosine_similarity(grads[k].flatten(),
                                        grads_ref[k].flatten(), 0))
           for k in grads}
    worst = min(cos, key=cos.get)
    if cos[worst] < 0.99:
        raise AssertionError(f"224² step gradient of {worst}: cosine "
                             f"{cos[worst]}")
    return dict(crop=cfg.bsize, tokens=cfg.tokens_hw, batch=TRAIN_BATCH,
                launches={k: launches[k] for k in ("attention_fwd",
                                                   "attention_bwd")},
                loss=[total, total_ref], min_cosine=[worst, cos[worst]])


def median_ms(fn, calls: int = AUG_CALLS) -> float:
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_h5_goldens(spec: dict) -> dict:
    """The goldens under ``hdf5_golden.json``'s ``"more"``, read by the
    package's own reader: every dataset to h5py's digest, the names listed
    as h5py lists them, each dangling soft link listed and read as
    missing. Returns the datasets checked per file."""
    out = {}
    for name, want in spec["more"].items():
        with hdf5.File(GOLDEN / name) as f:
            listed = set(want["datasets"]) | set(want["dangling"])
            if set(f) != listed:
                raise AssertionError(f"{name}: names {sorted(f)}")
            for k, d in want["datasets"].items():
                a = np.asarray(f[k][()])
                if (a.dtype.str != d["dtype"] or list(a.shape) != d["shape"]
                        or _sha256(a) != d["sha256"]):
                    raise AssertionError(f"{name} {k}: {a.dtype} {a.shape}, "
                                         f"not h5py's digest")
            for k in want["dangling"]:
                if k not in f or f.get(k) is not None:
                    raise AssertionError(f"{name}: dangling link {k} read")
        out[name] = len(want["datasets"])
    return out


def run_golden_h5_training(dev) -> dict:
    """The training phase's reader step (see the module docstring, step
    5): the committed ``hdf5_latest.h5`` read by the package's own reader
    to h5py's digest of every dataset, then ``H5_STEPS`` train steps at
    batch ``H5_BATCH`` of full ViT-L width on its items, with the
    attention kernels (1 forward, 5 backward) counted; then the goldens
    under ``"more"`` read to their digests, and ``H5_STEPS`` more steps
    on the items of ``H5_DEFAULT``, counted alike."""
    spec = json.loads(H5_JSON.read_text())
    t0 = time.perf_counter()
    with hdf5.File(H5_GOLDEN) as f:
        if set(f) != set(spec["datasets"]):
            raise AssertionError(f"{H5_GOLDEN.name}: datasets {sorted(f)}")
        for name, want in spec["datasets"].items():
            a = np.asarray(f[name][()])
            if (a.dtype.str != want["dtype"] or list(a.shape) != want["shape"]
                    or _sha256(a) != want["sha256"]):
                raise AssertionError(f"{H5_GOLDEN.name} {name}: {a.dtype} "
                                     f"{a.shape}, not h5py's digest")
        filters = {k: [f[k].compression, f[k].shuffle, f[k].fletcher32]
                   for k in ("images", "labels", "instance_counts")}
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    more = check_h5_goldens(spec)
    more_read_s = time.perf_counter() - t0
    ds = ClassposeHDF5Dataset(str(H5_GOLDEN), bsize=256, seed=SEED)
    ds_default = ClassposeHDF5Dataset(str(H5_DEFAULT), bsize=256, seed=SEED)
    n_classes = ds.n_classes
    if ds_default.n_classes != n_classes:
        raise AssertionError(f"{H5_DEFAULT.name}: {ds_default.n_classes} "
                             f"classes, {n_classes} in {H5_GOLDEN.name}")
    t0 = time.perf_counter()
    items = [ds[i] for i in range(H5_BATCH)]
    items_s = time.perf_counter() - t0
    # bf16: the trainer's kernel route (at fp32 its attention is plain
    # autograd and launches neither kernel)
    cfg = ClassTransformerConfig(n_cell_classes=n_classes,
                                 dtype="bfloat16")
    model = ClassposeModel(cfg=cfg, precision="bf16", device=dev, seed=SEED)
    lv = torch.zeros(3, device=dev)
    opt = make_optimizer(model.net, lv, 0.1, None, True)
    step = make_train_step(model.net, opt, lv, np.full(2 * H5_STEPS, 1e-5),
                           n_classes, use_uncertainty_weighting=True,
                           class_weights=ds.class_weights, rdrop=False)

    def steps(batch, what):
        X = torch.from_numpy(np.stack([x for x, _ in batch])).to(dev)
        lbl = torch.from_numpy(np.stack([y for _, y in batch])).to(dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        losses = [float(step(X, lbl)["total"]) for _ in range(H5_STEPS)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = {k: _build.LAUNCHES[k] for k in ("attention_fwd",
                                                   "attention_bwd")}
        for k, n in launches.items():
            if n != cfg.depth * H5_STEPS:
                raise AssertionError(f"{k}: {n} launches on {what}'s steps")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{what} step losses {losses}")
        return losses, wall, launches

    losses, steps_s, launches = steps(items, H5_GOLDEN.name)
    t0 = time.perf_counter()
    default_items = [ds_default[i] for i in range(H5_BATCH)]
    default_items_s = time.perf_counter() - t0
    default_losses, default_steps_s, default_launches = steps(
        default_items, H5_DEFAULT.name)
    del model, opt, step
    torch.cuda.empty_cache()
    return dict(datasets=len(spec["datasets"]), read_s=read_s,
                filters=filters, n_classes=n_classes, batch=H5_BATCH,
                items_s=items_s, steps=H5_STEPS, steps_s=steps_s,
                losses=losses, launches=launches,
                more=dict(datasets=more, read_s=more_read_s,
                          default_items_s=default_items_s,
                          default_steps_s=default_steps_s,
                          default_losses=default_losses,
                          default_launches=default_launches))


def run_training_cli(dev, work: str, targets: dict) -> dict:
    """The training CLI phase (see the module docstring, step 5): npy
    arrays → ``dataset_to_hdf5`` on the card → ``.h5`` → the augmentation
    alone → ``run_training --augmentation enhanced`` at full ViT-L."""
    work = Path(work)
    rng = np.random.default_rng(SEED)
    images, labels = disc_images(rng, TRAIN_IMAGES, TRAIN_SIZE, 60, 6)
    data = work / "data"
    data.mkdir()
    np.save(data / "images.npy", np.stack(images))
    np.save(data / "labels.npy", np.stack(labels))
    h5 = work / "train.h5"

    # (a) the targets and the file
    _build.reset_launches()
    t0 = time.perf_counter()
    dataset_to_hdf5_main(["--data_path", str(data), "--output", str(h5)])
    torch.cuda.synchronize()
    to_hdf5_s = time.perf_counter() - t0
    target_launches = _build.LAUNCHES["masked_diffusion"]
    if target_launches == 0:
        raise AssertionError("dataset_to_hdf5 launched no kernel 4")
    raw_bytes = sum(v.nbytes for v in targets.values())
    with hdf5.File(h5) as f:
        for name, ref in targets.items():
            got = np.asarray(f[name])
            if (got.dtype != ref.dtype or got.shape != ref.shape
                    or got.tobytes() != ref.tobytes()):
                raise AssertionError(
                    f"{name} in the .h5: {got.dtype} {got.shape}, not the "
                    f"training phase's {ref.dtype} {ref.shape} bit for bit")
        item = f["images"][0]

    # (b) each transform alone, forced to fire, on one 512² item (HED on
    # the item scaled to [0, 1]: its cutoff reads the raw mean)
    transforms = {
        "hed": (HEDTransform(seed=SEED), item / np.float32(255)),
        "he_staining": (HEStainingTransform(seed=SEED), item),
        "gaussian_blur_sigma2": (GaussianBlurTransform(
            p=1.0, sigma_range=(2.0, 2.0), seed=SEED), item),
        "additive_noise": (AdditiveNoiseTransform(p=1.0, seed=SEED), item),
        "hue_brightness_saturation": (HueBrightnessSaturationTransform(
            p=1.0, seed=SEED), item),
    }
    transform_ms = {}
    for name, (t, x) in transforms.items():
        out = t(x)
        if (out.shape != x.shape or not np.isfinite(out).all()
                or np.array_equal(out, x)):
            raise AssertionError(f"{name}: did not fire or not finite")
        transform_ms[name] = median_ms(lambda: t(x))
    ds = ClassposeHDF5Dataset(str(h5), augmentation_strategy="enhanced",
                              bsize=256, seed=SEED)
    ds[0]
    t0 = time.perf_counter()
    batch = [ds[i] for i in range(AUG_ITEMS)]
    batch_ms = (time.perf_counter() - t0) * 1e3
    if not all(np.isfinite(x).all() and x.shape == (3, 256, 256)
               for x, _ in batch):
        raise AssertionError("augmented items not finite or misshapen")

    # (c) the training CLI, items timed in ClassposeHDF5Dataset.__getitem__
    getitem = ClassposeHDF5Dataset.__getitem__
    spent = {"s": 0.0, "items": 0}

    def timed_getitem(self, index):
        t = time.perf_counter()
        out = getitem(self, index)
        spent["s"] += time.perf_counter() - t
        spent["items"] += 1
        return out

    losses = []

    class Losses(logging.Handler):
        def emit(self, record):
            losses.extend(float(v) for v in re.findall(
                r"Loss: (\S+?),?(?:\s|$)", record.getMessage()))

    trainer_log = logging.getLogger("classpose_tpu_torch.train.train")
    handler, level = Losses(), trainer_log.level
    trainer_log.addHandler(handler)
    trainer_log.setLevel(logging.INFO)
    ClassposeHDF5Dataset.__getitem__ = timed_getitem
    _build.reset_launches()
    try:
        t0 = time.perf_counter()
        # its .npz goes uncompressed, as in every phase (~65 s of zlib
        # on the host otherwise)
        with mock.patch.object(np, "savez_compressed", np.savez):
            path = run_training_main([
                "--data_path", str(h5), "--augmentation", "enhanced",
                "--epochs", str(CLI_EPOCHS), "--batch_size", str(CLI_BATCH),
                "--seed", "0", "--output_dir", str(work / "models"),
                "--model_name", "cli"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
    finally:
        ClassposeHDF5Dataset.__getitem__ = getitem
        trainer_log.removeHandler(handler)
        trainer_log.setLevel(level)
    cli_launches = dict(_build.LAUNCHES)
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"training CLI losses {losses}")
    meta = json.loads((Path(path).parent / "checkpoint_last.train" /
                       "meta.json").read_text())
    n_train = int(TRAIN_IMAGES * 0.9)
    steps = CLI_EPOCHS * (n_train // CLI_BATCH)

    sd, cfg = load_checkpoint(path)
    if cfg is None or cfg.embed_dim != 1024 or cfg.depth != 24:
        raise AssertionError(f"CLI weights: config {cfg}")
    model = ClassposeModel(cfg=cfg, params=sd, precision="fp32", device=dev)
    masks, flows, *_ = model.eval(np.stack(images)[0][:, :256, :256],
                                  channel_axis=0)
    if not all(np.isfinite(np.asarray(f)).all() for f in flows[1:3]):
        raise AssertionError("eval with the CLI's weights: not finite")
    return dict(
        to_hdf5_s=to_hdf5_s, target_launches=target_launches,
        h5_bytes=h5.stat().st_size, raw_bytes=raw_bytes,
        transform_ms=transform_ms, batch_items=AUG_ITEMS,
        batch_ms=batch_ms, cli_s=cli_s, cli_steps=steps,
        getitem_s=spent["s"], getitem_items=spent["items"],
        getitem_share=spent["s"] / cli_s, cli_launches=cli_launches,
        logged_losses=losses, train_losses=meta["train_losses"],
        weights=Path(path).name, eval_masks=int(np.asarray(masks).max()))


# ------------------------------------------------- phase 5, several ranks

class RecordedDataset:
    """A training dataset that records each item it hands out, in order,
    so that a run of several ranks can replay the same data."""

    def __init__(self, ds):
        self.ds, self.items = ds, []

    def __len__(self) -> int:
        return len(self.ds)

    def __getitem__(self, i):
        item = self.ds[i]
        self.items.append((int(i), item))
        return item

    def replay(self, class_weights) -> dict:
        """What the ranks replay: the items in draw order, the run's class
        weights and length. The learning rate of epoch e does not depend
        on the run's epoch count, so a replay of its first epochs takes
        its first steps."""
        return dict(indices=np.array([i for i, _ in self.items]),
                    X=np.stack([x for _, (x, _) in self.items]),
                    L=np.stack([y for _, (_, y) in self.items]),
                    class_weights=class_weights, length=len(self.ds))


class ReplayDataset:
    """Rank ``rank``'s view of a recorded one-process run at global batch
    ``batch``: its k-th request is the recorded item at global position
    ``(k // share) · batch + rank · share + k % share`` (share = batch /
    world), which must be the index the rank's sampler asks for."""

    def __init__(self, rec: dict, rank: int, world: int, batch: int):
        self.rec, self.rank, self.batch = rec, rank, batch
        self.share, self.k = batch // world, 0

    def __len__(self) -> int:
        return int(self.rec["length"])

    def __getitem__(self, i):
        k, self.k = self.k, self.k + 1
        pos = (k // self.share) * self.batch + self.rank * self.share \
            + k % self.share
        if int(self.rec["indices"][pos]) != int(i):
            raise AssertionError(f"rank {self.rank} asked for item {i} at "
                                 f"position {pos}, the run drew "
                                 f"{self.rec['indices'][pos]}")
        return self.rec["X"][pos], self.rec["L"][pos]


def weights_sha256(sd: dict) -> str:
    """SHA-256 of a ``state_dict``'s names, dtypes and values."""
    h = hashlib.sha256()
    for k in sorted(sd):
        v = sd[k].detach().cpu().contiguous()
        h.update(f"{k} {v.dtype}".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def replay_training(ds, class_weights, device, save_path: str, on_step
                    ) -> tuple[ClassposeModel, str]:
    """Phase 5's trainer configuration at :data:`RANK_DEPTH` blocks for
    :data:`RANK_EPOCHS` epochs on ``ds`` (a :class:`ReplayDataset`); the
    final ``.npz`` goes uncompressed, as in every phase (the parent reads
    rank 0's back). Returns the model and that path."""
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16",
                                 depth=RANK_DEPTH)
    model = ClassposeModel(cfg=cfg, precision="bf16", device=device,
                           seed=SEED)
    with mock.patch.object(np, "savez_compressed", np.savez):
        path, _, _ = train_class_seg(
            model, ds, batch_size=TRAIN_BATCH, n_epochs=RANK_EPOCHS,
            learning_rate=1e-4, save_path=save_path, model_name="ranks",
            class_weights=class_weights, use_uncertainty_weighting=True,
            random_seed=SEED, on_step=on_step)
    return model, path


def train_rank(work: str, backend: str) -> int:
    """One rank of the several-ranks phase (``chip_smoke.py --train-rank
    WORK BACKEND``, started by :func:`run_training_ranks`): phase 5's
    trainer on its share of phase 5's recorded items; writes
    ``WORK/rank<r>.json``."""
    shared = backend == "gloo"
    ctx = setup_distributed(torch.device("cuda", 0) if shared else "cuda",
                            backend=backend)
    rec = dict(np.load(f"{work}/replay.npz"))
    ds = ReplayDataset(rec, ctx.rank, ctx.world_size, TRAIN_BATCH)
    totals, stamps = [], []

    def on_step(step, metrics):
        torch.cuda.synchronize(ctx.device)
        totals.append(metrics["total"])
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats(ctx.device)
    _build.reset_launches()
    t0 = time.perf_counter()
    model, path = replay_training(ds, rec["class_weights"], ctx.device,
                                  f"{work}/rank{ctx.rank}", on_step)
    wall = time.perf_counter() - t0
    # a step's wall: the second step of each epoch (the first follows the
    # previous epoch's checkpoint write)
    per_epoch = len(totals) // RANK_EPOCHS
    step_s = statistics.median(stamps[i] - stamps[i - 1]
                               for i in range(len(stamps))
                               if i % per_epoch)
    out = dict(rank=ctx.rank, world=ctx.world_size, backend=ctx.backend,
               device=str(ctx.device), totals=totals,
               sha256=weights_sha256(model.net.state_dict()), path=path,
               trainer_s=wall,
               step_s=step_s, imgs_per_s=ds.share / step_s,
               peak_mem_gib=torch.cuda.max_memory_allocated(ctx.device)
               / 2 ** 30, launches=dict(_build.LAUNCHES))
    Path(work, f"rank{ctx.rank}.json").write_text(json.dumps(out))
    teardown_distributed()
    return 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_training_ranks(work: str, replay: dict) -> dict:
    """Several ranks, training (module docstring, step 5): two processes
    replay the first 2 epochs of phase 5's trainer run at 4 images a rank
    (global batch 8) at :data:`RANK_DEPTH` blocks, with NCCL on two cards
    when there are two, else both on ``cuda:0`` over gloo. Both ranks'
    final weights must be bitwise equal and held in rank 0's ``.npz``,
    and each step's total loss within :data:`RANK_LOSS_RTOL` of one
    process's run of the same configuration on the same items."""
    np.savez(f"{work}/replay.npz", **replay)
    # the one-process run at the ranks' depth, on the same items
    one = []
    t0 = time.perf_counter()
    replay_training(ReplayDataset(replay, 0, 1, TRAIN_BATCH),
                    replay["class_weights"], torch.device("cuda", 0),
                    f"{work}/one", lambda step, m: one.append(m["total"]))
    one_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    two_cards = torch.cuda.device_count() >= RANKS
    backend = "nccl" if two_cards else "gloo"
    me = [sys.executable, str(Path(__file__).resolve()), "--train-rank",
          work, backend]
    env = {**os.environ, "CLASSPOSE_DIST_TIMEOUT_S": str(RANK_COLLECTIVE_S)}
    if two_cards:
        cmds = [[sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", str(RANKS), *me[1:]]]
        envs = [env]
    else:
        port = free_port()
        cmds = [me] * RANKS
        envs = [{**env, "WORLD_SIZE": str(RANKS), "RANK": str(r),
                 "LOCAL_RANK": str(r), "MASTER_ADDR": "localhost",
                 "MASTER_PORT": str(port)} for r in range(RANKS)]
    t0 = time.perf_counter()
    logs = [open(f"{work}/launch{i}.log", "w") for i in range(len(cmds))]
    procs = [subprocess.Popen(c, env=e, stdout=f, stderr=subprocess.STDOUT)
             for c, e, f in zip(cmds, envs, logs)]
    try:
        deadline = t0 + RANKS_LIMIT_S
        rcs = [p.wait(timeout=max(1.0, deadline - time.perf_counter()))
               for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    if any(rcs):
        for i in range(len(cmds)):
            log(Path(f"{work}/launch{i}.log").read_text()[-4000:])
        raise AssertionError(f"several-ranks phase: exit codes {rcs}")
    ranks = [json.loads(Path(f"{work}/rank{r}.json").read_text())
             for r in range(RANKS)]
    ref = [float(v) for v in one]
    if len({r["sha256"] for r in ranks}) != 1:
        raise AssertionError("the ranks' final weights differ")
    if weights_sha256(load_checkpoint(ranks[0]["path"])[0]) \
            != ranks[0]["sha256"]:
        raise AssertionError("rank 0's .npz does not hold its weights")
    for r in ranks:
        if r["totals"] != ranks[0]["totals"]:
            raise AssertionError("the ranks logged different losses")
        for k in ("attention_fwd", "attention_bwd"):
            if r["launches"][k] == 0:
                raise AssertionError(f"rank {r['rank']}: {k} not launched")
    got = ranks[0]["totals"]
    ref = ref[:len(got)]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, ref)]
    if len(got) != len(ref) or max(rel) > RANK_LOSS_RTOL:
        raise AssertionError(f"step losses {got} vs one process {ref}")
    return dict(
        route=("two cards, torch.distributed.run, NCCL" if two_cards
               else "cuda:0 shared by two processes, gloo (CUDA tensors "
               "staged through the host)"),
        backend=backend, ranks=RANKS, depth=RANK_DEPTH,
        per_rank_batch=TRAIN_BATCH // RANKS, global_batch=TRAIN_BATCH,
        steps=len(got), wall_s=wall, one_process_s=one_s,
        step_totals=got, one_process_totals=ref, max_rel_diff=max(rel),
        weights_equal=True, npz_holds_weights=True,
        per_rank=[{k: r[k] for k in ("rank", "device", "imgs_per_s",
                                     "step_s", "peak_mem_gib",
                                     "trainer_s")} for r in ranks])


# ---------------------------------------------------------------- phase 6

def read_outputs(out_dir: str, base: str, labels: list[str]):
    """Parse the CLI's four outputs and check they agree: the contours
    and centroids GeoJSON, the densities CSV and the zarr store's
    centroid points. Returns (centroids (n, 2), class names)."""
    with open(f"{out_dir}/{base}_cell_contours.geojson") as f:
        contours = json.load(f)
    with open(f"{out_dir}/{base}_cell_centroids.geojson") as f:
        cents = json.load(f)
    n = len(contours["features"])
    if contours["type"] != "FeatureCollection" or len(cents["features"]) != n:
        raise AssertionError("contours and centroids disagree")
    for poly in contours["features"]:
        ring = poly["geometry"]["coordinates"][0]
        if poly["geometry"]["type"] != "Polygon" or len(ring) < 5 \
                or ring[0] != ring[-1]:
            raise AssertionError(f"bad polygon {poly['id']}")
    pts = np.array([c["geometry"]["coordinates"] for c in cents["features"]],
                   np.float64).reshape(n, 2)
    names = [c["properties"]["classification"]["name"]
             for c in cents["features"]]
    with open(f"{out_dir}/{base}_cellular_densities.csv") as f:
        rows = list(csv.DictReader(f))
    if [r["cell_class"] for r in rows] != labels \
            or sum(int(r["count"]) for r in rows) != n:
        raise AssertionError(f"densities CSV {rows} for {n} cells")
    zarr = f"{out_dir}/{base}_spatialdata.zarr"
    zx = read_zarr_array(f"{zarr}/points/cell_centroids/x")
    zc = read_zarr_array(f"{zarr}/points/cell_centroids/classification")
    if not np.array_equal(zx, pts[:, 0]) or list(zc) != names:
        raise AssertionError("zarr centroids disagree with the GeoJSON")
    return pts, names


def device_idle_share(trace_path: str) -> dict:
    """Device busy time (the union of kernel, memcpy and memset intervals
    on every stream) against the span of a torch.profiler chrome trace."""
    with open(trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    span0 = min(e["ts"] for e in events)
    span1 = max(e["ts"] + e["dur"] for e in events)
    busy, end = 0.0, -np.inf
    for t0, t1 in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                         if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset")):
        if t1 > end:
            busy += t1 - max(t0, end)
            end = t1
    span_ms = (span1 - span0) / 1e3
    return dict(traced_span_ms=span_ms, device_busy_ms=busy / 1e3,
                device_idle_share=1.0 - busy / 1e3 / span_ms)


def published_layout(sd: dict, n_classes: int) -> dict:
    """A port ``state_dict`` of a ViT-L in a published checkpoint's layout:
    the inverse of ``nn/convert.py``'s name map, the identity W2/W3 and
    the diam buffers; held key for key and shape for shape against the
    published ViT-L manifest."""
    man = vit_l_manifest(n_classes)
    back = {port: pub for pub, port in published_names(man).items()}
    pub = {back[k]: v for k, v in sd.items()}
    pub["diam_mean"] = torch.full((1,), 30.0)
    pub["diam_labels"] = torch.full((1,), 30.0)
    for name, c in (("W2", 3), ("W3", n_classes)):
        n = c * 64
        pub[name] = torch.eye(n).reshape(n, c, 8, 8)
    diff = manifest_diff(pub, man)
    if not diff["match"]:
        raise AssertionError(f"published layout vs manifest: {diff}")
    return pub


def run_wsi(dev, work: str) -> tuple[dict, dict, dict]:
    """The WSI CLI on a synthetic slide with the LayerNorm switch on (see
    the module docstring, step 6), with the ``.npz`` that
    ``classpose-convert-weights-torch`` writes from a published-layout
    ``conic.pt``. Returns the launches, the stats, and what the later
    WSI runs compare with."""
    os.environ["WSI_READER"] = "array"
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16")
    labels = DEFAULT_MODEL_CONFIGS["conic"]["cell_types"]
    t0 = time.perf_counter()
    slide, _ = synthetic_wsi(width=WSI_SIZE, height=WSI_SIZE, n_cells=4000,
                             mpp=WSI_MPP, seed=SEED)
    np.save(f"{work}/slide.npy", slide._level0)
    del slide
    slide_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    os.makedirs(f"{work}/models")
    pt = f"{work}/models/conic.pt"
    torch.save(published_layout(perturbed_structured_params(
        cfg, ripple=0.5, seed=SEED, attn_ripple=0.5), cfg.n_cell_classes),
        pt)
    pt_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # its .npz goes uncompressed (as in every phase), which
    # every later CLI run of the script also loads faster
    with mock.patch.object(np, "savez_compressed", np.savez):
        convert_cli(["--input", pt, "--output", f"{work}/vitl.npz"])
    convert_s = time.perf_counter() - t0
    with open(f"{work}/config.yaml", "w") as f:
        f.write(f"path: {work}/vitl.npz\nmpp: {WSI_MODEL_MPP}\n"
                "cell_types:\n" + "".join(f"- {c}\n" for c in labels))
    slide_args = ["--slide_path", f"{work}/slide.npy", "--device", "cuda:0",
                  "--precision", "bf16", "--batch_size", "32",
                  "--tile_size", "1024", "--overlap", "64", "--mpp",
                  str(WSI_MPP), "--output_type", "csv", "spatialdata"]

    def cli(out: str, *extra, args=slide_args):
        argv = ["--model_config", f"{work}/config.yaml",
                "--output_folder", out, *args, *extra]
        with ln_switch(True):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = main_with_args(argv)[0]
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0, dict(_build.LAUNCHES)

    res, wall, launches = cli(f"{work}/out")
    log(f"WSI launches: {launches}")
    missing = [k for k in WSI_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the WSI path: "
                             f"{missing}")
    pts, names = read_outputs(f"{work}/out", "slide", labels)
    # the design field: one cell per 32² model pixels over the 5×5 tile
    # grid's 4864² (tile origins are multiples of the period, so
    # overlapping tiles find the same cells and dedup keeps one)
    n_design = (4 * 960 + TILE) ** 2 // PERIOD ** 2
    if res["n_tiles"] != 25 or not (0.9 * n_design <= len(pts)
                                    <= 1.05 * n_design):
        raise AssertionError(f"{res['n_tiles']} tiles, {len(pts)} cells "
                             f"(design {n_design})")

    traced_res, _, _ = cli(f"{work}/out_traced", "--profile",
                           f"{work}/trace")
    idle = device_idle_share(f"{work}/trace/trace.json")

    restore = plain_versions()
    try:
        ref, plain_wall, _ = cli(f"{work}/out_plain")
    finally:
        restore()
    ref_pts, ref_names = read_outputs(f"{work}/out_plain", "slide", labels)
    share = matched_share(pts, names, ref_pts, ref_names)
    count_diff = abs(len(pts) - len(ref_pts)) / len(ref_pts)
    if count_diff > 0.005 or share < 0.99:
        raise AssertionError(f"WSI vs plain: {len(pts)} vs {len(ref_pts)} "
                             f"cells, {share:.4f} matched")
    stats = dict(
        slide_px=WSI_SIZE, slide_mpp=WSI_MPP, model_mpp=WSI_MODEL_MPP,
        make_slide_s=slide_s, write_pt_s=pt_s, convert_cli_s=convert_s,
        cli_wall_s=wall, pipeline_s=res["seconds"],
        slide_tiles_per_s=res["n_tiles"] / res["seconds"],
        n_tiles=res["n_tiles"], n_cells=res["n_cells"], n_design=n_design,
        stage_seconds=res["stage_seconds"],
        traced_pipeline_s=traced_res["seconds"], **idle,
        plain_cli_wall_s=plain_wall, plain_pipeline_s=ref["seconds"],
        plain_n_cells=ref["n_cells"], matched_share=share,
    )
    wsi = dict(cli=cli, work=work, slide_args=slide_args, labels=labels, pt=pt,
               pts=pts, names=names, n_design=n_design, seconds=res["seconds"],
               traced_seconds=traced_res["seconds"],
               stage_seconds=res["stage_seconds"], n_tiles=res["n_tiles"])
    return launches, stats, wsi


def matched_share(pts, names, ref_pts, ref_names) -> float:
    """Share of cells with a cell of the same class within 1 px in the
    other run."""
    from scipy.spatial import cKDTree

    dist, idx = cKDTree(ref_pts).query(pts, distance_upper_bound=1.0)
    return float(np.mean([np.isfinite(d) and names[i] == ref_names[j]
                          for i, (d, j) in enumerate(zip(dist, idx))]))


def sorted_features(path: str) -> list[str]:
    """A GeoJSON file's features, each without its random id, sorted."""
    with open(path) as f:
        feats = json.load(f)["features"]
    return sorted(json.dumps({k: v for k, v in f.items() if k != "id"},
                             sort_keys=True) for f in feats)


def run_wsi_multicard(wsi: dict) -> dict:
    """Several cards, WSI (module docstring, step 6): the WSI phase's
    slide, checkpoint and flags on two replicas, through the CLI with
    ``--device cuda:0,1`` where two cards are visible, else through
    ``pipeline.predict_wsi.main(..., devices=[cuda:0, cuda:0])``; its
    cells must be the one-card run's (equal count, every cell matched).
    It runs once, under ``--profile`` (the device idle share), and its
    seconds stand beside the one-card ``--profile`` run's."""
    work, labels = wsi["work"], wsi["labels"]
    two_cards = torch.cuda.device_count() >= 2
    cards = range(2 if two_cards else 1)
    model = None
    if not two_cards:
        # built once, as main_with_args builds it for all its slides
        config = resolve_model_config(f"{work}/config.yaml")
        model = build_model_from_config(
            config, precision="bf16", n_config_labels=len(config.cell_types),
            device=torch.device("cuda", 0))

    def run(out: str, *extra):
        argv = ["--model_config", f"{work}/config.yaml",
                "--output_folder", out, *wsi["slide_args"], *extra]
        with ln_switch(True):
            for i in cards:
                torch.cuda.synchronize(i)
            _build.reset_launches()
            t0 = time.perf_counter()
            if two_cards:
                res = main_with_args(argv + ["--device", "cuda:0,1"])[0]
            else:
                args = wsi_parser().parse_args(argv)
                args.slide_path = args.slide_path[0]
                res = wsi_main(args, model_override=model,
                               devices=[torch.device("cuda", 0)] * 2)
            for i in cards:
                torch.cuda.synchronize(i)
            return res, time.perf_counter() - t0, dict(_build.LAUNCHES)

    res, wall, launches = run(f"{work}/out_multi", "--profile",
                              f"{work}/trace_multi")
    missing = [k for k in WSI_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on two replicas: "
                             f"{missing}")
    if len(res["batches_per_device"]) != 2 \
            or min(res["batches_per_device"]) == 0:
        raise AssertionError(f"batches per replica "
                             f"{res['batches_per_device']}")
    pts, names = read_outputs(f"{work}/out_multi", "slide", labels)
    share = matched_share(pts, names, wsi["pts"], wsi["names"])
    if len(pts) != len(wsi["pts"]) or share != 1.0:
        raise AssertionError(f"two replicas: {len(pts)} cells, "
                             f"{share:.4f} matched, against one card's "
                             f"{len(wsi['pts'])}")
    identical = all(
        sorted_features(f"{work}/out_multi/slide_{kind}.geojson")
        == sorted_features(f"{work}/out/slide_{kind}.geojson")
        for kind in ("cell_contours", "cell_centroids"))
    del model
    idle = device_idle_share(f"{work}/trace_multi/trace.json")
    return dict(
        route=("--device cuda:0,1 (two cards)" if two_cards
               else "main(devices=[cuda:0, cuda:0]) (one card shared)"),
        devices=res["devices"], batches_per_device=res["batches_per_device"],
        wall_s=wall, traced_pipeline_s=res["seconds"],
        slide_tiles_per_s=res["n_tiles"] / res["seconds"],
        one_card_traced_pipeline_s=wsi["traced_seconds"],
        one_card_slide_tiles_per_s=wsi["n_tiles"] / wsi["traced_seconds"],
        n_tiles=res["n_tiles"], n_cells=len(pts),
        one_card_n_cells=len(wsi["pts"]), matched_share=share,
        sorted_features_identical=identical,
        stage_seconds=res["stage_seconds"], **idle, launches=launches)


# the WSI CLI as ``python -m classpose_tpu_torch.entrypoints.predict_wsi``
# runs it, in a process of its own, printing the launch counts last
PT_RUN = """
import json, runpy
from classpose_tpu_torch import _build
runpy.run_module("classpose_tpu_torch.entrypoints.predict_wsi",
                 run_name="__main__", alter_sys=True)
print(json.dumps(dict(_build.LAUNCHES)))
"""


def run_published(work: str, wsi: dict) -> dict:
    """The published checkpoint (see the module docstring, step 6): the
    WSI CLI with ``--model_config conic`` on ``$CLASSPOSE_MODEL_DIR/
    conic.pt``, in a process of its own, against the WSI phase's run on the
    converted ``.npz``; then ``classpose-parity-check-torch`` on the
    ``.pt`` on the card."""
    env = {**os.environ, "CLASSPOSE_MODEL_DIR": os.path.dirname(wsi["pt"]),
           LN_SWITCH: "1", "WSI_READER": "array"}
    out = f"{work}/out_pt"
    torch.cuda.empty_cache()  # the card's memory for the other process
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", PT_RUN, "--model_config", "conic",
         "--output_folder", out, *wsi["slide_args"]],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True)
    pt_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"--model_config conic run failed:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    launches = json.loads(proc.stdout.strip().splitlines()[-1])
    log(f".pt WSI launches: {launches}")
    missing = [k for k in WSI_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the .pt run: "
                             f"{missing}")
    pts, names = read_outputs(out, "slide", wsi["labels"])
    share = matched_share(pts, names, wsi["pts"], wsi["names"])
    if len(pts) != len(wsi["pts"]) or share != 1.0:
        raise AssertionError(f".pt vs converted .npz: {len(pts)} vs "
                             f"{len(wsi['pts'])} cells, {share} matched")

    _build.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        report = parity_cli(["--checkpoint", wsi["pt"], "--n_tiles", "1",
                             "--tile_size", "256", "--device", "cuda",
                             "--output", f"{work}/parity.json"])
    torch.cuda.synchronize()
    parity_s = time.perf_counter() - t0
    parity_launches = dict(_build.LAUNCHES)
    pl = report["per_layer"]
    log(f"parity check: {json.dumps(pl)}")
    if not report["manifest_diff"]["match"] or pl["missing_keys"] \
            or pl["unexpected_keys"] or not report["logit_parity_pass"] \
            or parity_launches["flash_attention_relpos"] == 0 \
            or not report["n_cells_per_tile"][0]:
        raise AssertionError(f"parity check: {json.dumps(report)}")
    stats = dict(
        pt_cli_wall_s=pt_wall, n_cells=len(pts), npz_n_cells=len(wsi["pts"]),
        matched_share=share, launches=launches,
        parity=dict(wall_s=parity_s, atol=report["atol"],
                    logit_parity_pass=report["logit_parity_pass"],
                    final_logits_max_diff=pl["final_logits_max_diff"],
                    layers=pl["layers"],
                    n_cells=report["n_cells_per_tile"],
                    launches=parity_launches))
    return stats


def run_wsi_fast_qc(wsi: dict) -> dict:
    """The WSI CLI once more with ``--fast_qc``: its cells against the
    design and the full-fidelity run."""
    res, wall, launches = wsi["cli"](f"{wsi['work']}/out_fast_qc",
                                     "--fast_qc")
    n = res["n_cells"]
    if not 0.9 * wsi["n_design"] <= n <= 1.05 * wsi["n_design"]:
        raise AssertionError(f"--fast_qc: {n} cells (design "
                             f"{wsi['n_design']})")
    return dict(cli_wall_s=wall, pipeline_s=res["seconds"], n_cells=n,
                full_fidelity_pipeline_s=wsi["seconds"],
                full_fidelity_n_cells=len(wsi["pts"]),
                stage_seconds=res["stage_seconds"], launches=launches)


def run_slide(wsi: dict) -> dict:
    """The slide phase (see the module docstring, step 6): the WSI phase's
    slide as a tiled-JPEG SVS written by the port's writer, read by the
    default reader; the exact chain through its decoded level 0; the
    golden stream; the codec's host rates."""
    work, labels = wsi["work"], wsi["labels"]
    level0 = np.load(f"{work}/slide.npy")
    H, W = level0.shape[:2]
    t0 = time.perf_counter()
    write_tiled_tiff(f"{work}/slide.svs", level0, mpp=WSI_MPP)
    write_s = time.perf_counter() - t0
    tiles = [np.ascontiguousarray(level0[y:y + SVS_TILE, x:x + SVS_TILE])
             for y in range(0, H, SVS_TILE) for x in range(0, W, SVS_TILE)]
    t0 = time.perf_counter()
    for t in tiles:
        jpeg.encode(t, SVS_QUALITY)
    encode_s = time.perf_counter() - t0

    slide = TiffSlide(f"{work}/slide.svs")
    n_tiles = len(slide._levels[0].offsets)
    if slide.level_dimensions[0] != (W, H) or n_tiles != len(tiles) \
            or get_slide_resolution(slide) != (WSI_MPP, WSI_MPP):
        raise AssertionError(f"SVS: {slide.level_dimensions}, {n_tiles} "
                             f"tiles, {slide.properties}")
    # the tile reads as the loader's threads make them, undecoded: the
    # decode rates below time the codec, not the file
    p = slide._levels[0]
    with open(f"{work}/slide.svs", "rb") as f:
        streams = []
        for off, n in zip(p.offsets, p.counts):
            f.seek(off)
            streams.append(f.read(n))
    t0 = time.perf_counter()
    for st in streams:
        jpeg.decode(st)
    decode_1t_s = time.perf_counter() - t0
    n_read = SlideLoader.n_read_threads
    with ThreadPoolExecutor(n_read) as pool:
        t0 = time.perf_counter()
        list(pool.map(jpeg.decode, streams))
        decode_nt_s = time.perf_counter() - t0
    tile_mp = n_tiles * SVS_TILE ** 2 / 1e6
    decoded = slide.read_region((0, 0), 0, (W, H))[..., :3]
    slide.close()
    np.save(f"{work}/decoded.npy", decoded)
    psnr = float(10 * np.log10(255.0 ** 2 / np.mean(
        (decoded.astype(np.float64) - level0) ** 2)))
    del level0, decoded

    # (d) the golden stream, bit for bit as PIL decoded it
    golden = jpeg.decode((GOLDEN / "jpeg_golden.jpg").read_bytes())
    if not np.array_equal(golden, np.load(GOLDEN / "jpeg_golden_rgb.npy")):
        raise AssertionError("the golden JPEG decodes unlike PIL")

    # the CLI on the SVS with WSI_READER unset: the MPP from its
    # description, not --mpp
    svs_args = [a for a in wsi["slide_args"] if a != str(WSI_MPP)
                and a != "--mpp"]
    svs_args[svs_args.index("--slide_path") + 1] = f"{work}/slide.svs"
    os.environ.pop("WSI_READER", None)
    try:
        res, wall, launches = wsi["cli"](f"{work}/out_svs", args=svs_args)
    finally:
        os.environ["WSI_READER"] = "array"
    log(f"SVS launches: {launches}")
    missing = [k for k in WSI_KERNELS if launches[k] == 0]
    if missing:  # (a)
        raise AssertionError(f"kernels not launched on the SVS run: "
                             f"{missing}")
    pts, names = read_outputs(f"{work}/out_svs", "slide", labels)
    share = matched_share(pts, names, wsi["pts"], wsi["names"])
    count_diff = abs(len(pts) - len(wsi["pts"])) / len(wsi["pts"])
    if res["n_tiles"] != wsi["n_tiles"] or count_diff > 0.005 \
            or share < 0.99:  # (b)
        raise AssertionError(f"SVS vs .npy: {res['n_tiles']} tiles, "
                             f"{len(pts)} vs {len(wsi['pts'])} cells, "
                             f"{share:.4f} matched")
    # (c) the SVS's decoded level 0 as an array slide: the same cells
    dec_args = list(wsi["slide_args"])
    dec_args[dec_args.index("--slide_path") + 1] = f"{work}/decoded.npy"
    dec, _, _ = wsi["cli"](f"{work}/out_decoded", args=dec_args)
    dec_pts, dec_names = read_outputs(f"{work}/out_decoded", "decoded",
                                      labels)
    exact = matched_share(dec_pts, dec_names, pts, names)
    if len(dec_pts) != len(pts) or exact != 1.0:
        raise AssertionError(f"decoded.npy vs SVS: {len(dec_pts)} vs "
                             f"{len(pts)} cells, {exact} matched")
    j2k = run_slide_j2k(wsi)
    jpeg_processes = run_slide_jpeg(wsi)
    czi_stats = run_slide_czi(wsi)
    return dict(j2k=j2k, jpeg_processes=jpeg_processes, czi=czi_stats,
        tile=SVS_TILE, quality=SVS_QUALITY, write_s=write_s,
        svs_mib=os.path.getsize(f"{work}/slide.svs") / 2 ** 20,
        level0_tiles=n_tiles, level0_psnr_db=psnr,
        encode_1t_mp_per_s=tile_mp / encode_s,
        decode_1t_mp_per_s=tile_mp / decode_1t_s,
        decode_threads=n_read, decode_nt_mp_per_s=tile_mp / decode_nt_s,
        decode_1t_s=decode_1t_s, decode_nt_s=decode_nt_s,
        cli_wall_s=wall, pipeline_s=res["seconds"],
        stage_seconds=res["stage_seconds"], n_cells=res["n_cells"],
        npy_pipeline_s=wsi["seconds"], npy_stage_seconds=wsi["stage_seconds"],
        npy_n_cells=len(wsi["pts"]), matched_share=share,
        decoded_pipeline_s=dec["seconds"], decoded_n_cells=dec["n_cells"],
        decoded_matched_share=exact, launches=launches)


def _sha256(rgb: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(rgb).tobytes()).hexdigest()


def run_slide_j2k(wsi: dict) -> dict:
    """The slide phase's JPEG 2000 step (see the module docstring, step
    6): the golden codestreams and the committed 33005 SVS's tiles against
    the hashes of PIL's pixels; the SVS through the CLI with
    ``WSI_READER`` unset against its region cut from ``slide.npy``; its
    decoded level 0 as an array slide; the decoder's host rates."""
    work, labels = wsi["work"], wsi["labels"]
    golden = json.loads(J2K_JSON.read_text())
    g = golden["svs"]
    if g["slide"] != dict(width=WSI_SIZE, height=WSI_SIZE, n_cells=4000,
                          mpp=WSI_MPP, seed=SEED):
        raise AssertionError(f"the J2K SVS is of another slide: {g}")
    # (a) every golden codestream and SVS tile, bit for bit as PIL decoded
    for name, want in golden["streams"].items():
        rgb = jpeg2000.decode((GOLDEN / f"{name}.j2k").read_bytes())
        if list(rgb.shape) != want["shape"] or _sha256(rgb) != want["sha256"]:
            raise AssertionError(f"golden {name} decodes unlike PIL")
    slide = TiffSlide(str(J2K_SVS))
    p = slide._levels[0]
    raw = J2K_SVS.read_bytes()
    streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
    if p.compression != 33005 or len(streams) != len(g["tiles"]) \
            or get_slide_resolution(slide) != (WSI_MPP, WSI_MPP):
        raise AssertionError(f"J2K SVS: compression {p.compression}, "
                             f"{len(streams)} tiles, {slide.properties}")
    for k, (st, want) in enumerate(zip(streams, g["tiles"])):
        if _sha256(jpeg2000.decode(st)) != want:
            raise AssertionError(f"J2K SVS tile {k} decodes unlike PIL")
    # (d) the decoder's rates on the card's host, one thread and the
    # loader's reader threads
    t0 = time.perf_counter()
    for st in streams:
        jpeg2000.decode(st)
    decode_1t_s = time.perf_counter() - t0
    n_read = SlideLoader.n_read_threads
    with ThreadPoolExecutor(n_read) as pool:
        t0 = time.perf_counter()
        list(pool.map(jpeg2000.decode, streams))
        decode_nt_s = time.perf_counter() - t0
    tile_mp = len(streams) * g["tile"] ** 2 / 1e6
    side = g["region"]
    decoded = slide.read_region((0, 0), 0, (side, side))[..., :3]
    slide.close()
    np.save(f"{work}/j2k_decoded.npy", decoded)
    region = np.load(f"{work}/slide.npy", mmap_mode="r")[:side, :side]
    np.save(f"{work}/region.npy", region)
    psnr = float(10 * np.log10(255.0 ** 2 / np.mean(
        (decoded.astype(np.float64) - region) ** 2)))
    del decoded, region

    # (b) the region as an array slide, the reference of this step and
    # of the JPEG-processes step, then the SVS (run_region_svs)
    npy_args = list(wsi["slide_args"])
    npy_args[npy_args.index("--slide_path") + 1] = f"{work}/region.npy"
    npy_args[npy_args.index("--tile_size") + 1] = str(J2K_MODEL_TILE)
    ref, _, _ = wsi["cli"](f"{work}/out_region", args=npy_args)
    ref_pts, ref_names = read_outputs(f"{work}/out_region", "region", labels)
    wsi["region_ref"] = (npy_args, ref, ref_pts, ref_names)
    svs = run_region_svs(wsi, J2K_SVS, f"{work}/j2k_decoded.npy")
    return dict(
        goldens=len(golden["streams"]), tiles=len(streams), tile=g["tile"],
        rate=g["rate"], svs_kib=len(raw) / 1024, level0_psnr_db=psnr,
        decode_1t_mp_per_s=tile_mp / decode_1t_s,
        decode_threads=n_read, decode_nt_mp_per_s=tile_mp / decode_nt_s,
        decode_1t_s=decode_1t_s, decode_nt_s=decode_nt_s,
        ext=run_slide_j2k_ext(wsi, golden),
        sub=run_slide_j2k_sub(wsi, golden),
        ht=run_slide_j2k_ht(wsi, golden), **svs)


def run_slide_j2k_ext(wsi: dict, golden: dict) -> dict:
    """The JPEG 2000 step's streams past Aperio's 8-bit raw codestreams:
    the ``j2k_ext_*`` goldens against PIL's hashes and the refused ones
    against their words; the lossless SVS's tiles against theirs, their
    decode rates by kind, and the SVS through the CLI with ``WSI_READER``
    unset, which must find exactly the region run's cells."""
    check_goldens(golden, "ext_streams", "refused")
    g = golden["ext_svs"]
    slide = TiffSlide(str(J2K_EXT_SVS))
    p = slide._levels[0]
    slide.close()
    raw = J2K_EXT_SVS.read_bytes()
    streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
    if p.compression != 33005 or len(streams) != len(g["tiles"]):
        raise AssertionError(f"J2K ext SVS: compression {p.compression}, "
                             f"{len(streams)} tiles")
    for k, (st, want) in enumerate(zip(streams, g["tiles"])):
        if _sha256(jpeg2000.decode(st)) != want:
            raise AssertionError(f"J2K ext SVS tile {k} decodes unlike PIL")
    return dict(goldens=len(golden["ext_streams"]),
                refused=len(golden["refused"]),
                part15=sorted(n for n in golden["ext_streams"]
                              if "part15" in n),
                svs_kib=len(raw) / 1024,
                decode_threads=SlideLoader.n_read_threads,
                decode_rates=j2k_rates_by_kind(streams, g["kinds"],
                                               golden["svs"]["tile"]),
                **run_region_svs(wsi, J2K_EXT_SVS, None))


def j2k_rates_by_kind(streams: list[bytes], kinds: list[str],
                      tile: int) -> dict:
    """The decoder's MP/s on the tiles of each kind (the kinds in turn,
    row-major): one thread, then the loader's reader threads on each
    kind's tiles repeated to as many as the threads."""
    n_read = SlideLoader.n_read_threads
    tile_mp = tile ** 2 / 1e6
    rates = {}
    with ThreadPoolExecutor(n_read) as pool:
        for i, kind in enumerate(kinds):
            group = streams[i::len(kinds)]
            t0 = time.perf_counter()
            for st in group:
                jpeg2000.decode(st)
            one = time.perf_counter() - t0
            many = group * max(1, n_read // len(group) * 2)
            t0 = time.perf_counter()
            list(pool.map(jpeg2000.decode, many))
            nt = time.perf_counter() - t0
            rates[kind] = dict(mp_per_s_1t=len(group) * tile_mp / one,
                               mp_per_s_nt=len(many) * tile_mp / nt)
    return rates


def check_goldens(golden: dict, decoded: str, refused: str) -> None:
    """Every stream of ``golden[decoded]`` decodes to PIL's hash and
    shape, and every one of ``golden[refused]`` raises naming its word."""
    for name, want in golden[decoded].items():
        rgb = jpeg2000.decode((GOLDEN / name).read_bytes())
        if list(rgb.shape) != want["shape"] or _sha256(rgb) != want["sha256"]:
            raise AssertionError(f"golden {name} decodes unlike PIL")
    for name, word in golden[refused].items():
        try:
            jpeg2000.decode((GOLDEN / name).read_bytes())
        except ValueError as e:
            if word not in str(e):
                raise AssertionError(f"{name} refused as {e!r}, not {word}")
        else:
            raise AssertionError(f"{name} decoded; it must raise ({word})")


def run_slide_j2k_sub(wsi: dict, golden: dict) -> dict:
    """The JPEG 2000 step's subsampled components: the ``j2k_sub_*``
    goldens against PIL's hashes and the refused ones against their
    words; the 33003 SVS's tiles against theirs, their decode rates by
    kind (4:2:0, 4:2:2), and the SVS through the CLI with ``WSI_READER``
    unset against the region run (lossy: cells within 0.5%, ≥ 99%
    matched), its level 0 decoded whole as an array slide (exactly its
    cells)."""
    work = wsi["work"]
    check_goldens(golden, "sub_streams", "sub_refused")
    g = golden["sub_svs"]
    slide = TiffSlide(str(J2K_SUB_SVS))
    p = slide._levels[0]
    raw = J2K_SUB_SVS.read_bytes()
    streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
    if p.compression != 33003 or len(streams) != len(g["tiles"]) \
            or get_slide_resolution(slide) != (WSI_MPP, WSI_MPP):
        raise AssertionError(f"J2K sub SVS: compression {p.compression}, "
                             f"{len(streams)} tiles, {slide.properties}")
    for k, (st, want) in enumerate(zip(streams, g["tiles"])):
        if _sha256(jpeg2000.decode(st)) != want:
            raise AssertionError(f"J2K sub SVS tile {k} decodes unlike PIL")
    rates = j2k_rates_by_kind(streams, g["kinds"], golden["svs"]["tile"])
    side = golden["svs"]["region"]
    decoded = slide.read_region((0, 0), 0, (side, side))[..., :3]
    slide.close()
    np.save(f"{work}/j2k_sub_decoded.npy", decoded)
    region = np.load(f"{work}/region.npy", mmap_mode="r")
    psnr = float(10 * np.log10(255.0 ** 2 / np.mean(
        (decoded.astype(np.float64) - region) ** 2)))
    del decoded, region
    return dict(goldens=len(golden["sub_streams"]),
                refused=len(golden["sub_refused"]), svs_kib=len(raw) / 1024,
                level0_psnr_db=psnr, decode_threads=SlideLoader.n_read_threads,
                decode_rates=rates,
                **run_region_svs(wsi, J2K_SUB_SVS,
                                 f"{work}/j2k_sub_decoded.npy"))


def run_slide_j2k_ht(wsi: dict, golden: dict) -> dict:
    """The JPEG 2000 step's HT code-blocks: the ``j2k_ht_*`` goldens
    against PIL's hashes and the refused ones against their words; the
    lossless HT SVS's tiles against theirs, the HT decode rate in MP/s on
    1 and on 4 host threads, and the SVS through the CLI with
    ``WSI_READER`` unset, which must find exactly the region run's
    cells."""
    check_goldens(golden, "ht_streams", "ht_refused")
    slide = TiffSlide(str(J2K_HT_SVS))
    p = slide._levels[0]
    slide.close()
    raw = J2K_HT_SVS.read_bytes()
    streams = [raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
    tiles = golden["ht_svs"]["tiles"]
    if p.compression != 33005 or len(streams) != len(tiles):
        raise AssertionError(f"J2K HT SVS: compression {p.compression}, "
                             f"{len(streams)} tiles")
    for k, (st, want) in enumerate(zip(streams, tiles)):
        if _sha256(jpeg2000.decode(st)) != want:
            raise AssertionError(f"J2K HT SVS tile {k} decodes unlike PIL")
    tile_mp = len(streams) * golden["svs"]["tile"] ** 2 / 1e6
    rates = {}
    for n in (1, 4):
        with ThreadPoolExecutor(n) as pool:
            t0 = time.perf_counter()
            list(pool.map(jpeg2000.decode, streams * n))
            rates[n] = n * tile_mp / (time.perf_counter() - t0)
    return dict(goldens=len(golden["ht_streams"]),
                refused=len(golden["ht_refused"]), svs_kib=len(raw) / 1024,
                decode_mp_per_s={str(k): v for k, v in rates.items()},
                **run_region_svs(wsi, J2K_HT_SVS, None))


def run_region_svs(wsi: dict, svs: Path, decoded: str | None,
                   reader: str | None = None) -> dict:
    """(b) a committed slide of the slide's region through the CLI with
    ``WSI_READER`` unset (an SVS, the MPP from its description) or set to
    ``reader``, against the run on the region as an array slide; (c) its
    level 0, decoded whole into ``decoded`` by the caller, as an array
    slide: exactly its cells. A lossless slide (``decoded`` None) must
    find exactly the region run's tiles and cells."""
    work, labels = wsi["work"], wsi["labels"]
    npy_args, ref, ref_pts, ref_names = wsi["region_ref"]
    svs_args = [a for a in npy_args if a not in (str(WSI_MPP), "--mpp")]
    svs_args[svs_args.index("--slide_path") + 1] = str(svs)
    os.environ.pop("WSI_READER", None)
    if reader is not None:
        os.environ["WSI_READER"] = reader
    try:
        res, wall, launches = wsi["cli"](f"{work}/out_{svs.stem}",
                                         args=svs_args)
    finally:
        os.environ["WSI_READER"] = "array"
    log(f"{svs.name} launches: {launches}")
    missing = [k for k in WSI_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on {svs.name}: "
                             f"{missing}")
    pts, names = read_outputs(f"{work}/out_{svs.stem}", svs.stem, labels)
    share = matched_share(pts, names, ref_pts, ref_names)
    count_diff = abs(len(pts) - len(ref_pts)) / len(ref_pts)
    lossless = decoded is None
    if res["n_tiles"] != ref["n_tiles"] or count_diff > 0.005 \
            or share < 0.99 or (lossless and (len(pts) != len(ref_pts)
                                              or share != 1.0)):
        raise AssertionError(f"{svs.name} vs region .npy: {res['n_tiles']} "
                             f"tiles, {len(pts)} vs {len(ref_pts)} cells, "
                             f"{share:.4f} matched")
    common = dict(
        cli_wall_s=wall, pipeline_s=res["seconds"],
        stage_seconds=res["stage_seconds"], n_tiles=res["n_tiles"],
        n_cells=res["n_cells"], npy_pipeline_s=ref["seconds"],
        npy_stage_seconds=ref["stage_seconds"], npy_n_cells=len(ref_pts),
        matched_share=share, launches=launches)
    if lossless:
        return common
    stem = Path(decoded).stem
    dec_args = list(npy_args)
    dec_args[dec_args.index("--slide_path") + 1] = decoded
    dec, _, _ = wsi["cli"](f"{work}/out_{stem}", args=dec_args)
    dec_pts, dec_names = read_outputs(f"{work}/out_{stem}", stem, labels)
    exact = matched_share(dec_pts, dec_names, pts, names)
    if len(dec_pts) != len(pts) or exact != 1.0:
        raise AssertionError(f"{stem}.npy vs {svs.name}: {len(dec_pts)} "
                             f"vs {len(pts)} cells, {exact} matched")
    return dict(common, decoded_pipeline_s=dec["seconds"],
                decoded_n_cells=dec["n_cells"], decoded_matched_share=exact)


def run_slide_jpeg(wsi: dict) -> dict:
    """The slide phase's JPEG-processes step (see the module docstring,
    step 6): the golden streams of every process against the hashes of
    PIL's pixels, the refused streams against their refusals, the
    committed compression-7 SVS's tiles at both levels against theirs;
    the SVS through the CLI with ``WSI_READER`` unset against the J2K
    step's region ``.npy`` run; its decoded level 0 as an array slide; the
    decoder's host rates by process."""
    work = wsi["work"]
    golden = json.loads(JPEG_JSON.read_text())
    g = golden["svs"]
    if g["slide"] != dict(width=WSI_SIZE, height=WSI_SIZE, n_cells=4000,
                          mpp=WSI_MPP, seed=SEED):
        raise AssertionError(f"the JPEG SVS is of another slide: {g}")
    # (a) every golden stream, bit for bit as PIL decoded it; every
    # stream PIL refuses raises, naming what it refuses
    for name, want in golden["streams"].items():
        rgb = jpeg.decode((GOLDEN / f"jpeg_{name}.jpg").read_bytes())
        if list(rgb.shape) != want["shape"] or _sha256(rgb) != want["sha256"]:
            raise AssertionError(f"golden jpeg_{name} decodes unlike PIL")
    for name, word in golden["refused"].items():
        try:
            jpeg.decode((GOLDEN / f"jpeg_refused_{name}.jpg").read_bytes())
        except ValueError as e:
            if word not in str(e):
                raise AssertionError(f"refused {name}: {e}") from e
        else:
            raise AssertionError(f"refused {name} decodes")
    slide = TiffSlide(str(JPEG_SVS))
    raw = JPEG_SVS.read_bytes()
    levels = [[raw[o:o + n] for o, n in zip(p.offsets, p.counts)]
              for p in slide._levels]
    if slide._levels[0].compression != 7 \
            or [len(v) for v in levels] != [len(v) for v in g["levels"]] \
            or get_slide_resolution(slide) != (WSI_MPP, WSI_MPP):
        raise AssertionError(f"JPEG SVS: {[len(v) for v in levels]} tiles, "
                             f"{slide.properties}")
    for lv, (streams, want) in enumerate(zip(levels, g["levels"])):
        for k, (st, w) in enumerate(zip(streams, want)):
            if _sha256(jpeg.decode(st)) != w["sha256"]:
                raise AssertionError(f"JPEG SVS level {lv} tile {k} decodes "
                                     f"unlike PIL")
    # (d) the decoder's rates on the card's host by process, one thread
    # and the loader's reader threads, each tile decoded
    # JPEG_RATE_REPEATS times
    by_process = {name: [] for name in g["processes"]}
    for st, w in zip(levels[0], g["levels"][0]):
        by_process[w["process"]].append(st)
    n_read = SlideLoader.n_read_threads
    rates = {}
    for name, streams in [*by_process.items(), ("all", levels[0])]:
        work_list = streams * JPEG_RATE_REPEATS
        mp = len(work_list) * g["tile"] ** 2 / 1e6
        t0 = time.perf_counter()
        for st in work_list:
            jpeg.decode(st)
        one = time.perf_counter() - t0
        with ThreadPoolExecutor(n_read) as pool:
            t0 = time.perf_counter()
            list(pool.map(jpeg.decode, work_list))
            many = time.perf_counter() - t0
        rates[name] = dict(tiles=len(streams), mp_per_s_1t=mp / one,
                           mp_per_s_nt=mp / many)
    damaged = run_damaged_svs(wsi, raw)
    side = g["region"]
    decoded = slide.read_region((0, 0), 0, (side, side))[..., :3]
    slide.close()
    np.save(f"{work}/jpeg_decoded.npy", decoded)
    region = np.load(f"{work}/region.npy", mmap_mode="r")
    psnr = float(10 * np.log10(255.0 ** 2 / np.mean(
        (decoded.astype(np.float64) - region) ** 2)))
    del decoded, region

    return dict(
        goldens=len(golden["streams"]), refused=len(golden["refused"]),
        tiles=[len(v) for v in levels], tile=g["tile"],
        quality=g["quality"], svs_kib=len(raw) / 1024, level0_psnr_db=psnr,
        decode_threads=n_read, decode_repeats=JPEG_RATE_REPEATS,
        decode_rates=rates, damaged=damaged,
        **run_region_svs(wsi, JPEG_SVS, f"{work}/jpeg_decoded.npy"))


def run_slide_czi(wsi: dict) -> dict:
    """The slide phase's CZI step (see the module docstring, step 6): (a)
    every CZI golden's reads against the hashes of the JAX reader's (made
    over the tests' pylibCZIrw fake), and the refused goldens against
    their refusals; (b) the committed region CZI through the CLI with
    ``WSI_READER=czi`` (the MPP from its metadata): exactly the tiles and
    cells of the J2K step's region ``.npy`` run; (c) the zstd decoder's
    rate on the card's host on one thread and on the reader threads, and
    both runs' pipeline seconds."""
    work = wsi["work"]
    t_step = time.perf_counter()
    golden = json.loads(CZI_JSON.read_text())
    g = golden["region"]
    if g["slide"] != dict(width=WSI_SIZE, height=WSI_SIZE, n_cells=4000,
                          mpp=WSI_MPP, seed=SEED):
        raise AssertionError(f"the region CZI is of another slide: {g}")
    jxr = run_jxr_goldens()
    n_reads = 0
    for name, f in golden["files"].items():
        slide = CZISlide(str(GOLDEN / f"{name}.czi"))
        if list(slide.dimensions) != f["dimensions"] or \
                slide.properties.get("openslide.mpp-x") != f["mpp"]:
            raise AssertionError(f"CZI {name}: {slide.dimensions}, "
                                 f"{slide.properties}")
        for x, y, lv, w, h, sha in f["reads"]:
            if _sha256(slide.read_region((x, y), lv, (w, h))) != sha:
                raise AssertionError(f"CZI {name} read {(x, y, lv, w, h)} "
                                     f"unlike the JAX reader's")
            n_reads += 1
        slide.close()
    for name, word in golden["refused"].items():
        path = str(GOLDEN / f"{name}.czi")
        if name.startswith("czi_refused_jpgxr"):
            # a JpgXr stream is refused when decoded: the file opens
            step, what = partial(CZISlide(path).read_region, (0, 0), 0,
                                 (16, 16)), "reads"
        else:
            step, what = partial(CZISlide, path), "opens"
        try:
            step()
        except ValueError as e:
            if word not in str(e):
                raise AssertionError(f"refused CZI {name}: {e}") from e
        else:
            raise AssertionError(f"refused CZI {name} {what}")
    # the region's level 0 is the region's pixels, exactly
    slide = CZISlide(str(CZI_REGION))
    side = g["region"]
    region = np.load(f"{work}/region.npy", mmap_mode="r")
    if not np.array_equal(
            slide.read_region((0, 0), 0, (side, side))[..., :3], region):
        raise AssertionError("the region CZI's level 0 is not the region")
    del region
    # (c) the zstd and JpgXr subblocks, their data read once, decoded on
    # one thread and on the loader's reader threads
    cf = CziFile(str(CZI_REGION))
    blocks = [b for b in cf.subblocks if b.compression in (ZSTD0, ZSTD1)]
    jobs = []
    for b in blocks:
        data = cf._data(b)
        w, h = b.stored
        start = data[0] if b.compression == ZSTD1 else 0
        jobs.append((data[start:], w * h * 3))
    xr_blocks = [b for b in cf.subblocks if b.compression == JPGXR]
    xr_jobs = [cf._data(b) for b in xr_blocks]
    xr_mp = sum(b.stored[0] * b.stored[1] for b in xr_blocks) \
        * CZI_RATE_REPEATS / 1e6
    cf.close()
    slide.close()
    work_list = jobs * CZI_RATE_REPEATS
    mb = sum(n for _, n in work_list) / 1e6
    t0 = time.perf_counter()
    for data, n in work_list:
        zstd.decompress(data, n)
    one = time.perf_counter() - t0
    n_read = SlideLoader.n_read_threads
    with ThreadPoolExecutor(n_read) as pool:
        t0 = time.perf_counter()
        list(pool.map(lambda j: zstd.decompress(*j), work_list))
        many = time.perf_counter() - t0
    xr_rates = {}
    for threads in sorted({1, 4, n_read}):
        with ThreadPoolExecutor(threads) as pool:
            t0 = time.perf_counter()
            list(pool.map(jpegxr.decode, xr_jobs * CZI_RATE_REPEATS))
            xr_rates[threads] = xr_mp / (time.perf_counter() - t0)
    cli = run_region_svs(wsi, CZI_REGION, None, reader="czi")
    return dict(
        goldens=len(golden["files"]), golden_reads=n_reads,
        refused=len(golden["refused"]), zstd_subblocks=len(blocks),
        jpgxr_subblocks=len(xr_blocks), jxr=jxr,
        czi_kib=CZI_REGION.stat().st_size / 1024,
        decode_threads=n_read, decode_repeats=CZI_RATE_REPEATS,
        zstd_mb_per_s_1t=mb / one, zstd_mb_per_s_nt=mb / many,
        jxr_mp_per_s={str(k): v for k, v in xr_rates.items()},
        step_s=time.perf_counter() - t_step, **cli)


def run_jxr_goldens() -> dict:
    """Every JPEG XR golden decodes to the hash of its encoder's pixels;
    every refused one raises naming its pixel format, and its codestream
    naming the header field."""
    golden = json.loads(JXR_JSON.read_text())
    for name, f in golden["files"].items():
        data = (GOLDEN / f"{name}.jxr").read_bytes()
        px = jpegxr.decode(data)
        if list(px.shape) != f["shape"] or str(px.dtype) != f["dtype"] \
                or _sha256(px) != f["sha256"]:
            raise AssertionError(f"JPEG XR {name} decodes unlike its "
                                 f"encoder's record")
    for name, f in golden["refused"].items():
        data = (GOLDEN / f"{name}.jxr").read_bytes()
        for fn, arg, word in ((jpegxr.decode, data, f["format"]),
                              (jpegxr.decode_codestream,
                               jpegxr.container(data).image,
                               f["codestream"])):
            try:
                fn(arg)
            except ValueError as e:
                if word not in str(e):
                    raise AssertionError(f"refused JPEG XR {name}: {e}") \
                        from e
            else:
                raise AssertionError(f"refused JPEG XR {name} decodes")
    return dict(goldens=len(golden["files"]),
                lossless=sum(f["lossless"] for f in golden["files"].values()),
                refused=len(golden["refused"]))


def run_damaged_svs(wsi: dict, raw: bytes) -> dict:
    """(e) the damaged copies of the JPEG SVS: the edited tile decodes to
    PIL's digest; the tile cut by its EOI raises, and the SVS holding it
    stops the WSI CLI (``WSI_READER`` unset) with the reader thread's
    ``RuntimeError`` caused by that ``ValueError``, where the JAX reader
    stops on PIL's "image file is truncated"."""
    sys.path.insert(0, str(GOLDEN))
    import jpeg_damage

    spec = json.loads(JPEG_DAMAGED_JSON.read_text())
    if spec["damages"] != jpeg_damage.DAMAGES:
        raise AssertionError(f"{JPEG_DAMAGED_JSON.name}: other damages")
    e = spec["damages"]["edited"]
    rgb = jpeg.decode(jpeg_damage.tile_stream(
        jpeg_damage.damaged(raw, "edited"), e["ifd"], e["tile"]))
    if _sha256(rgb) != spec["pil"]["edited"]["sha256"]:
        raise AssertionError("the edited JPEG tile decodes unlike PIL")
    t = spec["damages"]["truncated"]
    cut = jpeg_damage.damaged(raw, "truncated")
    try:
        jpeg.decode(jpeg_damage.tile_stream(cut, t["ifd"], t["tile"]))
    except ValueError as err:
        if "truncated" not in str(err):
            raise
    else:
        raise AssertionError("the JPEG tile cut by its EOI decodes")
    work = wsi["work"]
    path = Path(work) / "jpeg_truncated.svs"
    path.write_bytes(cut)
    args = [a for a in wsi["region_ref"][0]
            if a not in (str(WSI_MPP), "--mpp")]
    args[args.index("--slide_path") + 1] = str(path)
    os.environ.pop("WSI_READER", None)
    t0 = time.perf_counter()
    try:
        wsi["cli"](f"{work}/out_truncated", args=args)
    except RuntimeError as err:
        if str(err) != "slide reader thread failed" or \
                not isinstance(err.__cause__, ValueError) or \
                "truncated" not in str(err.__cause__):
            raise
        cause = str(err.__cause__)
    else:
        raise AssertionError("the WSI CLI ran through a truncated tile")
    finally:
        os.environ["WSI_READER"] = "array"
    return dict(edited_sha256=_sha256(rgb), truncated_stop_s=
                time.perf_counter() - t0, truncated_cause=cause)


def grandqc_weights(classes: int, seed: int) -> dict[str, torch.Tensor]:
    """Seeded random UNet++ weights over every key of ``grandqc_manifest``
    (the smp layout of the published checkpoints, step counters too):
    He-scaled convs, BatchNorm scales near 1, small biases and means and
    variances drawn positive, so activations stay finite through the 16
    MBConv blocks and the decoder."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in grandqc_manifest(classes).items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(1000, dtype=torch.int64)
            continue
        if k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif k.endswith(("running_mean", "bias")):
            v = rng.normal(0.0, 0.1, shape)
        elif len(shape) == 1:
            v = rng.uniform(0.8, 1.2, shape)
        else:
            v = rng.normal(0.0, np.sqrt(2.0 / np.prod(shape[1:])), shape)
        sd[k] = torch.from_numpy(v.astype(np.float32))
    return sd


def qc_patch_logits(net, img: np.ndarray, limit: int | None = None
                    ) -> np.ndarray:
    """Logits (C, H, W) of ``img`` on the net's device, assembled as
    ``predict_mask`` assembles its argmax (the first ``limit`` patches
    only: (n, C, 512, 512))."""
    grid = list(qc_helpers.iter_patches(img))
    if limit is not None:
        batch = np.stack([p for _, _, p in grid[:limit]])
        return unetpp_logits(net, batch).cpu().numpy()
    H, W = img.shape[:2]
    out = None
    for y, x, p in grid:
        lg = unetpp_logits(net, p[None])[0].cpu().numpy()
        if out is None:
            out = np.zeros((lg.shape[0], H, W), np.float32)
        h, w = min(512, H - y), min(512, W - x)
        out[:, y:y + h, x:x + w] = lg[:, :h, :w]
    return out


def run_grandqc(dev, wsi: dict) -> dict:
    """The GrandQC phase (see the module docstring, step 6): the WSI CLI
    on the ``.npy`` slide as QuPath calls it, with tissue and artefact
    models of random weights.

    The rule for the tissue head, fixed before any run: a random head's
    two logits are uncalibrated, so its argmax would call all of the slide
    tissue or none of it, and neither exercises the tile pre-filter. So,
    once, the class-1 bias is lowered by the median over the slide's
    MPP-10 thumbnail (JPEG-simulated, as the stage sees it) of logit₁ −
    logit₀, which the net computes on the card: about half of the
    thumbnail becomes tissue. The artefact head is left as drawn."""
    work, labels = wsi["work"], wsi["labels"]
    qc = f"{work}/grandqc"
    os.makedirs(qc)
    slide_path = f"{work}/slide.npy"
    stats: dict = {}

    # the stages' host and card steps, timed one by one
    slide = ArraySlide(slide_path)  # the reader the stages open
    t0 = time.perf_counter()
    thumb10, scale10, _ = qc_helpers.extract_slide_thumbnail(
        slide, MPP_TISSUE_MODEL)
    thumb1, scale1, _ = qc_helpers.extract_slide_thumbnail(
        slide, MPP_ARTEFACT_MODEL)
    stats["thumbnail_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sim10 = qc_helpers.simulate_jpeg_compression(thumb10)
    sim1 = qc_helpers.simulate_jpeg_compression(thumb1)
    stats["jpeg_simulation_s"] = time.perf_counter() - t0
    stats["thumbnails"] = dict(mpp10=list(thumb10.shape[:2]),
                               mpp1=list(thumb1.shape[:2]),
                               scale10=scale10, scale1=scale1)

    t_sd, a_sd = grandqc_weights(2, SEED + 1), grandqc_weights(8, SEED + 2)
    net = UnetPlusPlus(UnetPlusPlusConfig(classes=2))
    net.load_state_dict({k: v for k, v in t_sd.items()
                         if not k.endswith("num_batches_tracked")})
    d = qc_patch_logits(net.eval().to(dev), sim10)
    offset = float(np.median(d[1] - d[0]))
    t_sd["segmentation_head.0.bias"][1] -= offset
    stats["tissue_bias_offset"] = offset
    npz = {}
    for name, sd in (("tissue", t_sd), ("artefact", a_sd)):
        torch.save(sd, f"{qc}/{name}.pt")
        t0 = time.perf_counter()
        convert_cli(["--input", f"{qc}/{name}.pt", "--output",
                     f"{qc}/{name}.npz", "--kind", "grandqc", "--strict"])
        stats[f"convert_{name}_s"] = time.perf_counter() - t0
        npz[name] = f"{qc}/{name}.npz"

    t_fn = make_unetpp_predict_fn(npz["tissue"], 2, dev)
    a_fn = make_unetpp_predict_fn(npz["artefact"], 8, dev)
    t_fn(next(qc_helpers.iter_patches(sim10))[2][None])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    raw = qc_helpers.predict_mask(sim10, t_fn) == 1
    stats["tissue_forward_s"] = time.perf_counter() - t0
    tmask = resize_nearest(raw.astype(np.uint8), thumb1.shape[1],
                           thumb1.shape[0])
    tmask = tmask.astype(bool)

    def patch_filter(y, x, p):
        return tmask[y:y + p.shape[0], x:x + p.shape[1]].sum() >= \
            MIN_TISSUE_PIXELS

    t0 = time.perf_counter()
    amask = qc_helpers.predict_mask(sim1, a_fn, patch_filter=patch_filter,
                                    fill_value=7)
    stats["artefact_forward_s"] = time.perf_counter() - t0
    amask[~tmask] = 7
    stats["artefact_patches"] = int(sum(
        patch_filter(y, x, p) for y, x, p in qc_helpers.iter_patches(sim1)))
    t0 = time.perf_counter()
    filtered = qc_helpers.filter_components_by_area(raw, GRANDQC_MIN_AREA,
                                                    MPP_TISSUE_MODEL)
    n_regions = len(qc_helpers.contours_with_holes(filtered))
    for cls in range(2, 7):
        qc_helpers.contours_with_holes((amask == cls).astype(np.uint8),
                                       min_area_px=10)
    stats["contours_s"] = time.perf_counter() - t0
    stats["tissue_share"] = float(filtered.mean())
    stats["tissue_regions"] = n_regions
    stats["artefact_class_histogram"] = np.bincount(
        amask.ravel(), minlength=8).tolist()

    # UNet++ rate at batch 8 on the card: the predict_fn (upload, forward,
    # argmax, readback; host clock) and upload + forward (CUDA events)
    batch = np.stack([p for _, _, p in qc_helpers.iter_patches(sim1)]
                     [:GRANDQC_BATCH])
    batch = np.concatenate([batch] * (-(-GRANDQC_BATCH // len(batch))))[
        :GRANDQC_BATCH]
    a_net = load_unetpp(npz["artefact"], 8, dev)
    a_fn(batch)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        a_fn(batch)
    fn_s = (time.perf_counter() - t0) / reps
    fwd_ms = time_ms(lambda: unetpp_logits(a_net, batch))
    stats["unetpp_batch8"] = dict(
        predict_fn_ms=fn_s * 1e3, patches_per_s=GRANDQC_BATCH / fn_s,
        upload_forward_ms=fwd_ms,
        upload_forward_patches_per_s=GRANDQC_BATCH / fwd_ms * 1e3)

    # the card's masks against the same nets on the CPU
    agree, max_d = {}, {}
    for name, img, classes, limit in (
            ("tissue", sim10, 2, None),
            ("artefact", sim1, 8, GRANDQC_CPU_PATCHES)):
        gpu_net = load_unetpp(npz[name], classes, dev)
        cpu_net = load_unetpp(npz[name], classes, "cpu")
        t0 = time.perf_counter()
        lg = qc_patch_logits(gpu_net, img, limit)
        lc = qc_patch_logits(cpu_net, img, limit)
        stats[f"{name}_cpu_check_s"] = time.perf_counter() - t0
        ax = 0 if limit is None else 1
        agree[name] = float((lg.argmax(ax) == lc.argmax(ax)).mean())
        max_d[name] = float(np.abs(lg - lc).max())
    stats["card_vs_cpu_agreement"] = agree
    stats["card_vs_cpu_logits_max_abs"] = max_d
    log(f"GrandQC card vs CPU: agreement {agree}, logits max|Δ| {max_d}")
    if min(agree.values()) < 0.999:
        raise AssertionError(f"GrandQC masks, card vs CPU: {agree}")

    # the WSI CLI as QuPath calls it
    res, wall, launches = wsi["cli"](
        f"{work}/out_qc", "--tissue_detection_model_path", npz["tissue"],
        "--artefact_detection_model_path", npz["artefact"],
        "--filter_artefacts", "--min_area", str(GRANDQC_MIN_AREA))
    log(f"GrandQC WSI launches: {launches}")
    missing = [k for k in WSI_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the GrandQC WSI "
                             f"run: {missing}")
    if not 0 < res["n_tiles"] < wsi["n_tiles"]:
        raise AssertionError(f"tissue pre-filter kept {res['n_tiles']} of "
                             f"{wsi['n_tiles']} tiles")
    out = f"{work}/out_qc"
    pts, names = read_outputs(out, "slide", labels)
    qc_polys = {}
    for kind in ("tissue", "artefact"):
        with open(f"{out}/slide_{kind}_contours.geojson") as f:
            fc = json.load(f)
        if fc["type"] != "FeatureCollection":
            raise AssertionError(f"{kind} GeoJSON: {fc['type']}")
        qc_polys[kind] = [
            Polygon(ft["geometry"]["coordinates"][0],
                    holes=ft["geometry"]["coordinates"][1:])
            for ft in fc["features"]]
        store = Path(f"{out}/slide_spatialdata.zarr/shapes/"
                     f"{kind}_contours/geojson")
        if qc_polys[kind] and not store.is_dir():
            raise AssertionError(f"the store lacks {kind}_contours")
    if not qc_polys["tissue"]:
        raise AssertionError("no tissue region")

    # the same filters on the host, on the plain WSI run's cells
    with open(f"{work}/out/slide_cell_centroids.geojson") as f:
        cells = json.load(f)["features"]
    cells = filter_cells_by_tree(cells, STRtree(qc_polys["tissue"]), True)
    if qc_polys["artefact"]:
        cells = filter_cells_by_tree(cells, STRtree(qc_polys["artefact"]),
                                     False)
    ref_pts = np.array([c["geometry"]["coordinates"] for c in cells],
                       np.float64).reshape(-1, 2)
    ref_names = [c["properties"]["classification"]["name"] for c in cells]
    share = matched_share(pts, names, ref_pts, ref_names) if len(pts) \
        else 0.0
    count_diff = abs(len(pts) - len(ref_pts)) / max(len(ref_pts), 1)
    if not len(ref_pts) or count_diff > 0.005 or share < 0.99:
        raise AssertionError(f"GrandQC run vs the host-filtered plain run: "
                             f"{len(pts)} vs {len(ref_pts)} cells, "
                             f"{share:.4f} matched")
    stats.update(
        min_area_um2=GRANDQC_MIN_AREA, cli_wall_s=wall,
        pipeline_s=res["seconds"], stage_seconds=res["stage_seconds"],
        plain_pipeline_s=wsi["seconds"], n_tiles=res["n_tiles"],
        plain_n_tiles=wsi["n_tiles"], n_cells=res["n_cells"],
        host_filtered_n_cells=len(ref_pts), matched_share=share,
        tissue_polygons=len(qc_polys["tissue"]),
        artefact_polygons=len(qc_polys["artefact"]), launches=launches)
    return stats


# ---------------------------------------------------------------- phase 7

def design_dataset(rng) -> tuple[np.ndarray, np.ndarray]:
    """The evaluate phase's dataset: images (N, 3, S, S) float32 in
    [0, 255] (darker discs on a noisy background) and labels (N, 2, S, S)
    [instance, class]: the design field's cells (period 32, radius 13,
    centres at 16 + 32·k, what the structured checkpoint draws) as
    instances, all of the checkpoint's dominant class 1."""
    S = EVAL_SIZE
    yy, xx = np.mgrid[:S, :S]
    cy = (yy // PERIOD) * PERIOD + PERIOD // 2
    cx = (xx // PERIOD) * PERIOD + PERIOD // 2
    inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= RADIUS ** 2
    inst = np.where(inside, (yy // PERIOD) * (S // PERIOD) + xx // PERIOD
                    + 1, 0).astype(np.float32)
    lab = np.stack([inst, (inst > 0).astype(np.float32)])
    imgs = 200 + rng.normal(0, 8, (EVAL_CLI_IMAGES, 3, S, S)) - 60 * inside
    return (np.clip(imgs, 0, 255).astype(np.float32),
            np.repeat(lab[None], EVAL_CLI_IMAGES, axis=0))


def pq_rows_equal(a: list[dict], b: list[dict], keys) -> None:
    for ra, rb in zip(a, b):
        for k in keys:
            if abs(float(ra[k]) - float(rb[k])) > 1e-6:
                raise AssertionError(f"class {ra['class_id']} {k}: "
                                     f"{ra[k]} vs {rb[k]}")


PQ_KEYS = ("pq", "dq", "sq", "tp", "fp", "fn", "precision", "recall", "f1",
           "iou_sum")


def run_evaluate(dev, work: str) -> tuple[dict, dict]:
    """The evaluate CLI, the metrics CLI and the per-image API (see the
    module docstring, step 7), with the WSI phase's checkpoint."""
    cfg = ClassTransformerConfig(n_cell_classes=6)
    ckpt = f"{work}/vitl.npz"
    data = f"{work}/conic"
    os.makedirs(data)
    images, labels = design_dataset(np.random.default_rng(SEED))
    np.save(f"{data}/images.npy", images)
    np.save(f"{data}/labels.npy", labels)
    grid = compute_tile_grid(EVAL_SIZE, EVAL_SIZE, cfg.bsize)
    chunks = chunk_plan(grid.ny * grid.nx, EVAL_BATCH)[0]

    def cli(out: str):
        argv = ["--data_path", data, "--model_path", ckpt, "--output_dir",
                out, "--device", "cuda", "--precision", "fp32",
                "--batch_size", str(EVAL_BATCH)]
        printed = io.StringIO()
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = evaluate_cli(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        preds = np.load(f"{out}/predictions.npy")
        with open(f"{out}/metrics.csv") as f:
            rows = list(csv.DictReader(f))
        if preds.shape != (EVAL_CLI_IMAGES, EVAL_SIZE, EVAL_SIZE, 2) \
                or preds.dtype != np.int32 or "pq" not in printed.getvalue():
            raise AssertionError(f"evaluate outputs {preds.shape} "
                                 f"{preds.dtype}")
        pq_rows_equal(rows, res["metrics"], PQ_KEYS)
        return res, wall, dict(_build.LAUNCHES), preds, printed.getvalue()

    res, wall, launches, preds, table = cli(f"{work}/eval")
    log(f"evaluate launches: {launches}\n{table}")
    want = cfg.depth * chunks * EVAL_CLI_IMAGES
    if launches["flash_attention_relpos"] != want:
        raise AssertionError(f"head-major attention launches "
                             f"{launches['flash_attention_relpos']}, want "
                             f"{want} ({cfg.depth} per crop chunk)")
    missing = [k for k in EVALUATE_KERNELS if launches[k] == 0]
    if missing or launches["masked_diffusion"] or launches["attention_fwd"]:
        raise AssertionError(f"evaluate path launches {launches}")
    n_design = (EVAL_SIZE // PERIOD) ** 2
    counts = [int(len(np.unique(p[..., 0])) - 1) for p in preds]
    cls1 = res["metrics"][0]
    if not all(0.95 * n_design <= c <= n_design for c in counts) \
            or cls1["class_id"] != 1 or cls1["pq"] < 0.8:
        raise AssertionError(f"instances {counts} (design {n_design}), "
                             f"class 1 {cls1}")

    restore = plain_versions()
    try:
        res_plain, plain_wall, _, preds_plain, _ = cli(f"{work}/eval_plain")
    finally:
        restore()
    worst = compare_slices([(p[..., 0], p[..., 1]) for p in preds],
                           [(p[..., 0], p[..., 1]) for p in preds_plain])

    # the metrics CLI on the evaluate CLI's outputs: the GT's classes are
    # 1 only, so its table has class 1 where the evaluate CLI's has the
    # model's six; class 1 must agree
    np.save(f"{work}/gt.npy",
            np.stack([labels[:, 0], labels[:, -1]], -1).astype(np.int32))
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rows = metrics_cli(["--gt_path", f"{work}/gt.npy", "--pred_path",
                            f"{work}/eval/predictions.npy", "--output",
                            f"{work}/cm/metrics.csv"])
    metrics_cli_s = time.perf_counter() - t0
    pq_rows_equal(rows[:1], res["metrics"][:1], PQ_KEYS)

    # the per-image API: one 448² image under the profiler, one 256² image
    # (aligned: kernel 4, not kernel 7)
    model = ClassposeModel(pretrained_model=ckpt, nclasses=6,
                           precision="fp32", device=dev)
    x = images[0].transpose(1, 2, 0)
    model.eval(x, batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.eval(x, batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    breakdown = traced(lambda: model.eval(x, batch_size=EVAL_BATCH))
    log(f"eval breakdown: {json.dumps(breakdown)}")
    _build.reset_launches()
    m256 = model.eval(np.ascontiguousarray(x[:256, :256]),
                      batch_size=EVAL_BATCH)[0]
    l256 = dict(_build.LAUNCHES)
    if l256["masked_diffusion"] == 0 or l256["diffuse_blocked"] \
            or l256["flash_attention_relpos"] != cfg.depth \
            or len(np.unique(m256)) - 1 < 0.95 * (256 // PERIOD) ** 2:
        raise AssertionError(f"256² eval: launches {l256}, "
                             f"{len(np.unique(m256)) - 1} instances")
    del model

    # eval's 3D branch in bf16 (kernel 1), against the plain versions
    model3 = ClassposeModel(pretrained_model=ckpt, nclasses=6,
                            precision="bf16", device=dev)
    stack = np.random.default_rng(SEED).integers(
        0, 256, size=STACK_SHAPE + (3,)).astype(np.float32)
    _build.reset_launches()
    t0 = time.perf_counter()
    m3, flows3, c3, _ = model3.eval(stack, do_3D=True,
                                    batch_size=EVAL_BATCH)
    torch.cuda.synchronize()
    stack_s = time.perf_counter() - t0
    l3 = dict(_build.LAUNCHES)
    restore = plain_versions()
    try:
        m3_ref = model3.eval(stack, do_3D=True, batch_size=EVAL_BATCH)[0]
    finally:
        restore()
    n3, n3_ref = int(m3.max()), int(m3_ref.max())
    fg3 = float(((m3 > 0) == (m3_ref > 0)).mean())
    if m3.shape != STACK_SHAPE or m3.dtype != np.int32 \
            or l3["attention_fwd"] == 0 or l3["flash_attention_relpos"] \
            or not np.isfinite(flows3[1]).all() or n3 == 0 \
            or abs(n3 - n3_ref) > max(2, 0.05 * n3_ref) or fg3 < 0.98:
        raise AssertionError(f"3D eval: {m3.shape} {m3.dtype}, launches "
                             f"{l3}, {n3} vs {n3_ref} instances, fg "
                             f"agreement {fg3}")
    del model3

    stats = dict(
        images=EVAL_CLI_IMAGES, size=EVAL_SIZE,
        crops_per_image=grid.ny * grid.nx,
        cli_wall_s=wall, inference_s=res["inference_s"],
        images_per_s=EVAL_CLI_IMAGES / res["inference_s"],
        pq_s=res["metrics_s"], metrics_cli_s=metrics_cli_s,
        pq_class1=cls1["pq"], instances=counts, n_design=n_design,
        plain_cli_wall_s=plain_wall,
        plain_inference_s=res_plain["inference_s"],
        worst_iou_vs_plain=worst, one_image_eval_s=image_s,
        eval_breakdown=breakdown, launches_256=l256,
        stack=dict(shape=STACK_SHAPE, eval_s=stack_s, launches=l3,
                   instances=n3, plain_instances=n3_ref,
                   fg_agreement=fg3),
    )
    return launches, stats


def run_semantic(dev, work: str, wsi: dict, smi: str) -> tuple[dict, dict]:
    """The paper's semantic Cellpose-SAM baseline (module docstring, step
    7) at full ViT-L width and fp32 on the WSI phase's ``conic.pt``:
    ``run_cellpose_semantic.main`` trains the graft for two epochs and
    predicts; then ``main --skip_training`` on the donor's weights with the
    class head that training learned, held to the plain versions and to
    the bare graft. (A step at a learning rate above 0 moves the
    structured donor's blocks off the exact cancellations its field rests
    on, so the trained net itself draws no cells.)"""
    d = f"{work}/semantic"
    os.makedirs(d)
    rng = np.random.default_rng(SEED + 23)
    images, labels = disc_images(rng, SEM_TRAIN, SEM_TRAIN_SIZE, 20,
                                 SEM_CLASSES)
    np.save(f"{d}/train_x.npy", np.clip(np.stack(images), 0, 255).astype(
        np.uint8).transpose(0, 2, 3, 1))
    np.save(f"{d}/train_y.npy",
            np.stack(labels).astype(np.int32).transpose(0, 2, 3, 1))
    test = np.clip(design_dataset(rng)[0], 0, 255).astype(
        np.uint8).transpose(0, 2, 3, 1)
    np.save(f"{d}/test_x.npy", test)
    argv = ["--train_data_path", f"{d}/train_x.npy", "--train_labels_path",
            f"{d}/train_y.npy", "--test_data_path", f"{d}/test_x.npy",
            "--dataset_name", "lizard", "--training_to_inference_mpp",
            SEM_SPEC, "--device", "cuda"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    # the .npz files uncompressed, as in every phase
    with mock.patch.object(np, "savez_compressed", np.savez):
        res = semantic_main(argv + [
            "--out_path", f"{d}/trained.npy", "--epochs", str(SEM_EPOCHS),
            "--pretrained", wsi["pt"], "--save_path", f"{d}/models"])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        trained_preds = np.load(f"{d}/trained.npy", allow_pickle=True)
        if (trained_preds.dtype != object
                or trained_preds.shape != test.shape[:3] + (2,)
                or res["train_images"] != SEM_EPOCHS * SEM_TRAIN
                or not os.path.isdir(
                    f"{d}/models/cellpose_lizard/checkpoint_last.train")):
            raise AssertionError(f"semantic outputs {trained_preds.dtype} "
                                 f"{trained_preds.shape}, {res}")
        trained, cfg = load_checkpoint(res["model_path"])
        donor, _ = load_checkpoint(wsi["pt"])
        graft = semantic_head(donor["out.weight"], donor["out.bias"],
                              SEM_CLASSES, cfg.ps)
        head = (trained["out_class.weight"], trained["out_class.bias"])
        head_moved = max(float((p - g).abs().max())
                         for p, g in zip(head, graft))
        if cfg.n_cell_classes != SEM_CLASSES or head_moved == 0:
            raise AssertionError(f"saved model: {cfg.n_cell_classes} "
                                 f"classes, head moved {head_moved}")
        os.makedirs(f"{d}/kept/cellpose_lizard")
        save_params({**{k: v for k, v in donor.items()
                        if not k.startswith("out_class.")},
                     "out_class.weight": head[0], "out_class.bias": head[1]},
                    f"{d}/kept/cellpose_lizard/cellpose_lizard.npz", cfg)
        del trained, donor, head
        t0 = time.perf_counter()
        kept_res = semantic_main(argv + [
            "--out_path", f"{d}/kept.npy", "--skip_training",
            "--save_path", f"{d}/kept"])
        torch.cuda.synchronize()
        kept_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    log(f"semantic baseline launches: {launches}")
    # both calls view each image as one crop
    want_attn = 2 * ClassTransformerConfig().depth * len(test)
    missing = [k for k in SEM_KERNELS if launches[k] == 0]
    if missing or launches["flash_attention_relpos"] != want_attn \
            or launches["attention_fwd"] or launches["attention_bwd"]:
        raise AssertionError(f"semantic baseline launches {launches}")
    preds = np.load(f"{d}/kept.npy", allow_pickle=True)
    if preds.dtype != object or preds.shape != test.shape[:3] + (2,):
        raise AssertionError(f"semantic outputs {preds.dtype} {preds.shape}")
    maps = [np.asarray(p, np.int32) for p in preds]
    counts = [int(len(np.unique(m[..., 0])) - 1) for m in maps]
    trained_counts = [int(len(np.unique(np.asarray(p)[..., 0])) - 1)
                      for p in trained_preds]
    # the design field's cells in the model's 224² view (its padding to
    # one 256² crop moves the field against the image's edges)
    n_design = (EVAL_SIZE // 2 // PERIOD) ** 2
    if not all(0.5 * n_design <= c <= 2 * n_design for c in counts) or any(
            m[..., 1].max() >= SEM_CLASSES or m[..., 1].min() < 0
            for m in maps):
        raise AssertionError(f"semantic instances {counts} (design "
                             f"{n_design})")

    # the same model under the plain versions, then with the bare graft,
    # through the script's own prediction loop
    t0 = time.perf_counter()
    model = ClassposeModel(pretrained_model=kept_res["model_path"],
                           precision="fp32", device=dev)
    load_s = time.perf_counter() - t0
    restore = plain_versions()
    try:
        plain = semantic_predict(model, test, SEM_SPEC)
    finally:
        restore()
    worst = compare_slices([(m[..., 0], m[..., 1]) for m in maps],
                           [(m[..., 0], m[..., 1]) for m in plain])
    if worst != 1.0:
        raise AssertionError(f"semantic baseline vs plain: worst IoU {worst}")
    with torch.no_grad():
        model.net.out_class.weight.copy_(graft[0])
        model.net.out_class.bias.copy_(graft[1])
    bare = semantic_predict(model, test, SEM_SPEC)
    del model, graft

    def cell_classes(ms):
        return [int(m[..., 1][m[..., 0] == i][0]) for m in ms
                for i in np.unique(m[..., 0]) if i > 0]

    classes, bare_classes = cell_classes(maps), cell_classes(bare)
    if any(not np.array_equal(m[..., 0], b[..., 0])
           for m, b in zip(maps, bare)) or classes == bare_classes:
        raise AssertionError(f"trained head's classes {set(classes)} vs "
                             f"the bare graft's {set(bare_classes)}")
    # steps within one epoch: the intervals between epochs hold the
    # checkpoint writes, the first step the warm-up
    ends, per_epoch = res["step_ends"], SEM_TRAIN // 4
    inner = [ends[i] - ends[i - 1] for i in range(1, len(ends))
             if i % per_epoch]
    stats = dict(
        donor=os.path.basename(wsi["pt"]), classes=SEM_CLASSES,
        train_images=SEM_TRAIN, train_size=SEM_TRAIN_SIZE,
        epochs=SEM_EPOCHS, train_steps=res["train_images"] // 4,
        step_ends_s=ends, train_imgs_per_s=4 * len(inner) / sum(inner),
        trainer_s=res["train_s"],
        trainer_imgs_per_s=res["train_images"] / res["train_s"],
        head_max_change=head_moved, trained_instances=trained_counts,
        peak_mem_gib=peak, test_images=len(test), test_size=EVAL_SIZE,
        spec=SEM_SPEC, eval_s=kept_res["eval_s"],
        eval_images_per_s=kept_res["eval_images"] / kept_res["eval_s"],
        main_s=main_s, skip_training_main_s=kept_s, npz_load_s=load_s,
        instances=counts, n_design=n_design,
        cell_classes={c: classes.count(c) for c in sorted(set(classes))},
        bare_graft_cell_classes={c: bare_classes.count(c)
                                 for c in sorted(set(bare_classes))},
        worst_iou_vs_plain=worst, launches=launches)
    log(f"semantic baseline ({smi}): training {stats['train_imgs_per_s']:.2f}"
        f" imgs/s between steps of one epoch; trainer {res['train_s']:.2f} s "
        f"for {res['train_images']} images ({stats['trainer_imgs_per_s']:.2f}"
        f" imgs/s, with its warm-up and checkpoint writes), peak "
        f"{peak:.1f} GiB; head moved {head_moved:.3g}; trained net "
        f"{trained_counts} cells; eval {stats['eval_images_per_s']:.2f} "
        f"images/s; main {main_s:.1f} s + {kept_s:.1f} s; cell classes "
        f"{stats['cell_classes']} (bare graft "
        f"{stats['bare_graft_cell_classes']})")
    return launches, stats


def run_fault3_eval(dev, bsize: int = FAULT3_BSIZE,
                    S: int = FAULT3_SIZE) -> dict:
    """Fault 3 at inference: a full-width ViT-L whose config has crops of
    ``bsize`` (224: 28 × 28 tokens; 1024: 128 × 128, L = 16384) with a
    live structured checkpoint (``perturbed_structured_params``, attention
    ripple 0.5), ``eval`` on one design-field image of S² (480²: 3 × 3
    crops, 2 chunks of 8; 1024²: one crop) in fp32 (kernel 8) and bf16
    (kernel 1), each on the kernel route and with the plain versions
    swapped in (one head at a time past L = 4096: the plain attention's
    (L, L) fp32 intermediates): one launch per block and crop chunk; masks
    compared as masks (equal counts, worst IoU ≥ 0.95, equal classes) and
    the network's flows and cell probability (the blended output) within
    1e-3·max|ref| at fp32 and 5e-2·max|ref| at bf16."""
    cfg = ClassTransformerConfig(n_cell_classes=6, bsize=bsize)
    params = perturbed_structured_params(cfg, ripple=0.5, seed=SEED,
                                         attn_ripple=0.5)
    by_head = cfg.tokens_hw ** 2 > 4096
    yy, xx = np.mgrid[:S, :S]
    inside = ((yy % PERIOD - PERIOD // 2) ** 2
              + (xx % PERIOD - PERIOD // 2) ** 2 <= RADIUS ** 2)
    x = np.clip(200 + np.random.default_rng(SEED).normal(0, 8, (S, S, 3))
                - 60 * inside[..., None], 0, 255).astype(np.float32)
    grid = compute_tile_grid(S, S, cfg.bsize)
    chunks = chunk_plan(grid.ny * grid.nx, EVAL_BATCH)[0]
    out = {}
    for precision, kernel, tol in (("fp32", "flash_attention_relpos", 1e-3),
                                   ("bf16", "attention_fwd", 5e-2)):
        model = ClassposeModel(cfg=cfg, params=params, precision=precision,
                               device=dev)
        model.eval(x, batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        m, flows, c, _ = model.eval(x, batch_size=EVAL_BATCH)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        if launches[kernel] != cfg.depth * chunks:
            raise AssertionError(f"bsize {bsize} {precision} eval: "
                                 f"{launches}, want {cfg.depth * chunks} of "
                                 f"{kernel}")
        restore = plain_versions(by_head)
        try:
            m_ref, flows_ref, c_ref, _ = model.eval(x, batch_size=EVAL_BATCH)
        finally:
            restore()
        worst = compare_slices([(m, c)], [(m_ref, c_ref)])
        rel_err = {}
        for name, i in (("flows", 1), ("cellprob", 2)):
            a, r = np.asarray(flows[i], np.float64), np.asarray(
                flows_ref[i], np.float64)
            if a.shape != r.shape or not np.isfinite(a).all():
                raise AssertionError(f"bsize {bsize} {precision} {name}")
            rel_err[name] = float(np.abs(a - r).max() / np.abs(r).max())
            if rel_err[name] > tol:
                raise AssertionError(f"bsize {bsize} {precision} {name}: "
                                     f"max|Δ|/max|ref| {rel_err[name]}")
        n_design = (S // PERIOD) ** 2
        if not 0.95 * n_design <= int(m.max()) <= n_design:
            raise AssertionError(f"bsize {bsize} {precision}: {m.max()} "
                                 f"cells (design {n_design})")
        out[precision] = dict(eval_s=wall, kernel_launches=launches[kernel],
                              instances=int(m.max()), n_design=n_design,
                              worst_iou_vs_plain=worst,
                              rel_err_vs_plain=rel_err)
        del model
    return dict(bsize=cfg.bsize, tokens=cfg.tokens_hw, image=S,
                crops=grid.ny * grid.nx, chunks=chunks,
                plain_by_head=by_head, **out)


def big_crop_train_step(dev) -> dict:
    """Fault 3 at the largest crop: one bf16 train step on the kernel
    route at batch 1 of a 1024² crop (128 × 128 tokens, L = 16384) of one
    1024² disc image (~240 discs, flow targets by kernel 4), full ViT-L
    width and depth, seeded random weights, without layer-drop: a finite
    loss, finite gradients and ``depth`` launches each of kernels 1 and 5.
    Cut: no plain step beside it (the plain vjp keeps several (L, L) fp32
    tensors per head and block, ~1 GiB each); kernel 5's arithmetic at
    128 × 128 is held against the plain vjp in ``check_fault3_grids``."""
    cfg = ClassTransformerConfig(n_cell_classes=6, dtype="bfloat16",
                                 bsize=BIG_BSIZE)
    rng = np.random.default_rng(SEED)
    images, labels = disc_images(rng, 1, BIG_SIZE, 240, cfg.n_cell_classes)
    tr_d, tr_l, tr_diam, *_ = process_train_test(images, labels, device=dev)
    ds = ClassposeTrainingDataset(np.stack(tr_d), np.stack(tr_l),
                                  diameter_array=tr_diam, bsize=cfg.bsize,
                                  seed=SEED)
    x, y = ds[0]
    X = torch.from_numpy(x[None]).to(dev)
    lbl = torch.from_numpy(y[None]).to(dev)
    net = ClassposeModel(cfg=cfg, precision="bf16", device=dev,
                         seed=SEED).net
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    total, grads = step_grads(net, X, lbl, ds.class_weights,
                              cfg.n_cell_classes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in ("attention_fwd",
                                                "attention_bwd")}
    if any(v != cfg.depth for v in launches.values()):
        raise AssertionError(f"bsize {BIG_BSIZE} step launches {launches}")
    if not np.isfinite(total) or not all(bool(torch.isfinite(g).all())
                                         for g in grads.values()):
        raise AssertionError(f"bsize {BIG_BSIZE} step: loss {total}")
    return dict(crop=cfg.bsize, tokens=cfg.tokens_hw, batch=1, loss=total,
                launches=launches, step_s=wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", action="store_true",
                    help=f"also A/B the kernels against the bodies of "
                    f"{AB_PARENT} (phase 8)")
    ap.add_argument("--train-rank", nargs=2, metavar=("WORK", "BACKEND"),
                    help="run one rank of the several-ranks phase (started "
                    "by the phase itself)")
    args = ap.parse_args()
    if args.train_rank:
        return train_rank(*args.train_rank)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {smi}")

    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build {time.perf_counter() - t0:.1f} s: {per_source}")
    for name in _build.SOURCES:
        _build.lib(name)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    kernels = []
    for check in (lambda: check_attention(gen, dev),
                  lambda: check_attention_bwd(gen, dev),
                  lambda: check_sampler(gen, dev),
                  lambda: check_histogram(gen, dev),
                  lambda: check_diffusion(dev),
                  lambda: check_layernorm(gen, dev),
                  lambda: check_diffuse_blocked(gen, dev),
                  lambda: check_flash_attention(gen, dev)):
        k = check()
        torch.cuda.synchronize()
        log(f"{k['name']}: max|Δ| {k['max_abs_err']:.3g}, "
            f"{k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, library "
            f"{k['library_ms']}, bound {k['bound_ms']:.4f} by "
            f"{k['bound_by']})")
        kernels.append(k)
    sampling_shapes = check_sampling_shapes(gen, dev)
    log(f"sampler/histogram at other shapes: {sampling_shapes}")
    fault3_grids = check_fault3_grids(gen, dev)
    log(f"fault 3 grids: {json.dumps(fault3_grids)}")

    launches, stats, path_landing, slice_model = run_slice(dev)
    log(f"slice: {json.dumps(stats)}")
    fast_qc = run_fast_qc(dev, slice_model)
    del slice_model
    log(f"fast QC: {json.dumps(fast_qc)}")
    with tempfile.TemporaryDirectory() as out_dir:
        train_launches, train_stats, targets = run_training(dev, out_dir)
    replay = targets.pop("replay")
    log(f"training: {json.dumps(train_stats)}")
    h5_stats = run_golden_h5_training(dev)
    log(f"golden .h5: {json.dumps(h5_stats)}")
    h5_more = h5_stats["more"]
    log(f"golden .h5 more: {sum(h5_more['datasets'].values())} datasets of "
        f"{len(h5_more['datasets'])} files as h5py's digests in "
        f"{h5_more['read_s']:.3f} s; {H5_STEPS} steps on "
        f"{H5_DEFAULT.name}'s soft-linked items, launches "
        f"{h5_more['default_launches']}")
    with tempfile.TemporaryDirectory() as work:
        cli_stats = run_training_cli(dev, work, targets)
    with tempfile.TemporaryDirectory() as work:
        ranks_stats = run_training_ranks(work, replay)
    del targets, replay
    log(f"several ranks: {json.dumps(ranks_stats)}")
    log(f"several ranks ({ranks_stats['route']}): "
        + ", ".join(f"rank {r['rank']} {r['imgs_per_s']:.2f} imgs/s, peak "
                    f"{r['peak_mem_gib']:.1f} GiB" for r in
                    ranks_stats["per_rank"])
        + f"; step losses within {ranks_stats['max_rel_diff']:.2e} of one "
        "process; weights bitwise equal")
    log(f"training CLI: {json.dumps(cli_stats)}")
    log(f"training CLI (host unless named): dataset_to_hdf5 "
        f"{cli_stats['to_hdf5_s']:.3f} s ({cli_stats['target_launches']} "
        f"kernel 4 launches), .h5 {cli_stats['h5_bytes']} bytes of "
        f"{cli_stats['raw_bytes']} raw; transforms (median ms) "
        f"{cli_stats['transform_ms']}; {AUG_ITEMS} items "
        f"{cli_stats['batch_ms']:.1f} ms; CLI {cli_stats['cli_s']:.2f} s for "
        f"{cli_stats['cli_steps']} steps, __getitem__ "
        f"{cli_stats['getitem_s']:.2f} s "
        f"({100 * cli_stats['getitem_share']:.1f}%)")
    with tempfile.TemporaryDirectory() as work:
        wsi_launches, wsi_stats, wsi = run_wsi(dev, work)
        log(f"wsi: {json.dumps(wsi_stats)}")
        multi = run_wsi_multicard(wsi)
        log(f"several cards, WSI: {json.dumps(multi)}")
        log(f"several cards, WSI ({multi['route']}): batches "
            f"{multi['batches_per_device']}, "
            f"{multi['traced_pipeline_s']:.2f} s traced, "
            f"{multi['slide_tiles_per_s']:.2f} slide tiles/s (one card "
            f"{multi['one_card_slide_tiles_per_s']:.2f}), idle share "
            f"{multi['device_idle_share']:.3f}, {multi['n_cells']} cells, "
            f"matched {multi['matched_share']}, sorted features identical: "
            f"{multi['sorted_features_identical']}")
        published = run_published(work, wsi)
        log(f"published checkpoint: {json.dumps(published)}")
        fast_qc["wsi"] = run_wsi_fast_qc(wsi)
        log(f"--fast_qc WSI: {json.dumps(fast_qc['wsi'])}")
        slide_stats = run_slide(wsi)
        log(f"slide: {json.dumps(slide_stats)}")
        log(f"slide write {slide_stats['write_s']:.3f} s, encode "
            f"{slide_stats['encode_1t_mp_per_s']:.2f} MP/s; decode "
            f"{slide_stats['decode_1t_mp_per_s']:.2f} MP/s on 1 thread, "
            f"{slide_stats['decode_nt_mp_per_s']:.2f} MP/s on "
            f"{slide_stats['decode_threads']} (host); SVS pipeline "
            f"{slide_stats['pipeline_s']:.3f} s {slide_stats['stage_seconds']}"
            f" vs .npy {slide_stats['npy_pipeline_s']:.3f} s "
            f"{slide_stats['npy_stage_seconds']}")
        j2k = slide_stats["j2k"]
        log(f"slide J2K: decode {j2k['decode_1t_mp_per_s']:.2f} MP/s on 1 "
            f"thread, {j2k['decode_nt_mp_per_s']:.2f} MP/s on "
            f"{j2k['decode_threads']} (host); J2K SVS pipeline "
            f"{j2k['pipeline_s']:.3f} s {j2k['stage_seconds']} vs region "
            f".npy {j2k['npy_pipeline_s']:.3f} s {j2k['npy_stage_seconds']} "
            f"(the first run at 512² tiles) and its decoded level 0 as .npy "
            f"{j2k['decoded_pipeline_s']:.3f} s; {j2k['n_cells']} vs "
            f"{j2k['npy_n_cells']} cells, {j2k['matched_share']:.4f} matched")
        ext = j2k["ext"]
        log(f"slide J2K ext: {ext['goldens']} goldens as PIL's pixels "
            f"(Part 15 signalling: {', '.join(ext['part15'])}), "
            f"{ext['refused']} refusals by name; lossless SVS decode (host "
            f"MP/s on 1 thread / on {ext['decode_threads']}): " + ", ".join(
                f"{k} {v['mp_per_s_1t']:.2f} / {v['mp_per_s_nt']:.2f}"
                for k, v in ext["decode_rates"].items())
            + f" beside the 8-bit 9/7 tiles' {j2k['decode_1t_mp_per_s']:.2f}"
            f" / {j2k['decode_nt_mp_per_s']:.2f}; pipeline "
            f"{ext['pipeline_s']:.3f} s {ext['stage_seconds']}; "
            f"{ext['n_cells']} vs {ext['npy_n_cells']} cells, "
            f"{ext['matched_share']:.4f} matched")
        sub = j2k["sub"]
        log(f"slide J2K sub: {sub['goldens']} goldens as PIL's pixels, "
            f"{sub['refused']} refusals by name; 33003 SVS decode (host "
            f"MP/s on 1 thread / on {sub['decode_threads']}): " + ", ".join(
                f"{k} {v['mp_per_s_1t']:.2f} / {v['mp_per_s_nt']:.2f}"
                for k, v in sub["decode_rates"].items())
            + f"; level 0 {sub['level0_psnr_db']:.2f} dB; pipeline "
            f"{sub['pipeline_s']:.3f} s {sub['stage_seconds']}, its decoded "
            f"level 0 as .npy {sub['decoded_pipeline_s']:.3f} s; "
            f"{sub['n_cells']} vs {sub['npy_n_cells']} cells, "
            f"{sub['matched_share']:.4f} matched")
        ht = j2k["ht"]
        log(f"slide J2K HT: {ht['goldens']} goldens as PIL's pixels, "
            f"{ht['refused']} refusals by name; lossless HT SVS "
            f"({ht['svs_kib']:.0f} KiB) decode "
            f"{ht['decode_mp_per_s']['1']:.2f} MP/s on 1 host thread, "
            f"{ht['decode_mp_per_s']['4']:.2f} MP/s on 4 ({smi}); pipeline "
            f"{ht['pipeline_s']:.3f} s {ht['stage_seconds']} vs region .npy "
            f"{ht['npy_pipeline_s']:.3f} s; {ht['n_cells']} vs "
            f"{ht['npy_n_cells']} cells, {ht['matched_share']:.4f} matched")
        jp = slide_stats["jpeg_processes"]
        log("slide JPEG processes (host MP/s on 1 thread / on "
            f"{jp['decode_threads']}): " + ", ".join(
                f"{k} {v['mp_per_s_1t']:.2f} / {v['mp_per_s_nt']:.2f}"
                for k, v in jp["decode_rates"].items())
            + f"; JPEG SVS pipeline {jp['pipeline_s']:.3f} s "
            f"{jp['stage_seconds']} vs region .npy "
            f"{jp['npy_pipeline_s']:.3f} s, its decoded level 0 as .npy "
            f"{jp['decoded_pipeline_s']:.3f} s; {jp['n_cells']} vs "
            f"{jp['npy_n_cells']} cells, {jp['matched_share']:.4f} matched")
        cz = slide_stats["czi"]
        log(f"slide JPEG XR: {cz['jxr']['goldens']} goldens as their "
            f"encoder's pixels ({cz['jxr']['lossless']} lossless), "
            f"{cz['jxr']['refused']} refusals by name; the region CZI's "
            f"{cz['jpgxr_subblocks']} JpgXr subblocks decode at " + ", ".join(
                f"{v:.2f} MP/s on {k} thread{'s' if k != '1' else ''}"
                for k, v in cz["jxr_mp_per_s"].items()) + " (host)")
        log(f"slide CZI: {cz['golden_reads']} golden reads and "
            f"{cz['refused']} refusals as the JAX reader's; zstd "
            f"{cz['zstd_mb_per_s_1t']:.2f} MB/s on 1 thread, "
            f"{cz['zstd_mb_per_s_nt']:.2f} MB/s on {cz['decode_threads']} "
            f"(host); CZI pipeline {cz['pipeline_s']:.3f} s "
            f"{cz['stage_seconds']} vs region .npy "
            f"{cz['npy_pipeline_s']:.3f} s; {cz['n_cells']} vs "
            f"{cz['npy_n_cells']} cells, {cz['matched_share']:.4f} matched; "
            f"the step {cz['step_s']:.1f} s")
        rates = {"SOF0": dict(
            mp_per_s_1t=slide_stats["decode_1t_mp_per_s"],
            mp_per_s_nt=slide_stats["decode_nt_mp_per_s"]),
            **jp["decode_rates"]}
        log("decode MP/s on 1 thread / on the reader threads, PR 15's "
            "proof run in brackets: " + ", ".join(
                f"{k} {rates[k]['mp_per_s_1t']:.2f} / "
                f"{rates[k]['mp_per_s_nt']:.2f} [{a} / {b}]"
                for k, (a, b) in PR15_DECODE_RATES.items()))
        log(f"damaged JPEG SVS: {json.dumps(jp['damaged'])}")
        grandqc_stats = run_grandqc(dev, wsi)
        log(f"grandqc: {json.dumps(grandqc_stats)}")
        log(f"GrandQC (host unless named): thumbnails "
            f"{grandqc_stats['thumbnail_s']:.3f} s, JPEG simulation "
            f"{grandqc_stats['jpeg_simulation_s']:.3f} s, tissue forward "
            f"{grandqc_stats['tissue_forward_s']:.3f} s, artefact forward "
            f"{grandqc_stats['artefact_forward_s']:.3f} s, UNet++ "
            f"{grandqc_stats['unetpp_batch8']['patches_per_s']:.1f} "
            f"patches/s at batch {GRANDQC_BATCH}, contours "
            f"{grandqc_stats['contours_s']:.3f} s; pipeline "
            f"{grandqc_stats['pipeline_s']:.3f} s with QC vs "
            f"{grandqc_stats['plain_pipeline_s']:.3f} s")
        ev_launches, ev_stats = run_evaluate(dev, work)
        log(f"evaluate: {json.dumps(ev_stats)}")
        t0 = time.perf_counter()
        _, sem_stats = run_semantic(dev, work, wsi, smi)
        sem_stats["phase_s"] = time.perf_counter() - t0
    log(f"semantic baseline: {json.dumps(sem_stats)}")
    fault3_eval = run_fault3_eval(dev)
    log(f"fault 3 eval: {json.dumps(fault3_eval)}")
    big_eval = run_fault3_eval(dev, BIG_BSIZE, BIG_SIZE)
    log(f"bsize {BIG_BSIZE} eval: {json.dumps(big_eval)}")
    big_step = big_crop_train_step(dev)
    log(f"bsize {BIG_BSIZE} train step: {json.dumps(big_step)}")
    ab = None
    if args.ab:
        ab = dict(old=AB_PARENT, **run_ab(
            parent_sources(AB_PARENT), BUILD / "ab_ptxas.txt", path_landing))
        log(f"A/B: {json.dumps(ab)}")
    for k in kernels:
        # each kernel's count from the phase whose path runs it: the
        # eval slice, training for the attention backward, the WSI path
        # (its switch on) for the LayerNorm, the evaluate CLI for the
        # head-major attention and the halo-blocked diffusion
        name = k["name"]
        k["launches"] = (launches[name] if name in EVAL_KERNELS
                         else wsi_launches[name] if name == "layernorm"
                         else ev_launches[name]
                         if name in ("flash_attention_relpos",
                                     "diffuse_blocked")
                         else train_launches[name])
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    by_name = {k["name"]: k for k in kernels}
    wall = time.perf_counter() - T_START
    log(f"script wall {wall:.1f} s")
    print(f"script wall {wall:.1f} s")
    print(smi)
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels],
                      "slice": stats, "training": train_stats,
                      "wsi": wsi_stats, "published": published,
                      "slide": slide_stats, "grandqc": grandqc_stats,
                      "training_cli": cli_stats, "golden_h5": h5_stats,
                      "several_cards_wsi": multi,
                      "several_ranks_training": ranks_stats,
                      "fast_qc": fast_qc, "evaluate": ev_stats,
                      "semantic_baseline": sem_stats,
                      "layernorm_neck": by_name["layernorm"]["neck"],
                      "diffuse_blocked_shapes": by_name["diffuse_blocked"][
                          "shapes"],
                      "landing_histogram_inputs": by_name[
                          "landing_histogram"]["inputs"],
                      "flash_attention_relpos_bf16": by_name[
                          "flash_attention_relpos"]["bf16"],
                      "attention_detail": {
                          name: {key: v for key, v in by_name[name].items()
                                 if key not in order and key != "bf16"}
                          for name in ("attention_fwd",
                                       "flash_attention_relpos")},
                      "sampling_shapes": sampling_shapes,
                      "bilinear_sample_spread": by_name["bilinear_sample"][
                          "spread"],
                      "bilinear_sample_library_spread": by_name[
                          "bilinear_sample"]["library_spread"],
                      "fault3_grids": fault3_grids,
                      "fault3_eval": fault3_eval,
                      "bsize1024": dict(eval=big_eval, train_step=big_step),
                      "diffusion_detail": {
                          k: by_name["masked_diffusion"][k]
                          for k in ("launches_per_call", "target_512")},
                      "ab": ab}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
