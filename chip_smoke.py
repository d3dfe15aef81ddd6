#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --against ROOT [ROOT ...] [--kernel NAME [NAME ...]]
        # A/B of the redesigned kernels only (against_phase): all seven, or
        # galerkin_scores (the float32 forward, also against float64),
        # galerkin_scores_bwd (float32), galerkin_scores_bwd_bf16,
        # galerkin_scores_bf16 (the bfloat16 forward), fourier_chain
        # (float32), fourier_chain_bf16 or fourier_chain_mixed by name; with
        # either forward, also the device time of the ex2 requests and train
        # step of its type with each checkout's forward (forward_path_phase);
        # with fourier_chain, that of the ex1 fourier f32 request at n = 8192
        # and train step (chain_path_phase); with fourier_chain_bf16 or
        # fourier_chain_mixed, that of the ex1 fourier bf16 request and train
        # step with each checkout's two bfloat16 chains
    python3 chip_smoke.py --stage-sweep
        # the float32 galerkin forward with only its copies, only LN, only
        # the product and whole, at the ex1 width over n (stage_sweep_phase)
    python3 chip_smoke.py --cosine-bf16
        # bf16 cosine serving's distance from the float32 model on four
        # seeds, the CPU's and the card's, ex1 and ex2 (cosine_bf16_phase)
    python3 chip_smoke.py --profile-float64
        # the memory profiles' galerkin and fourier gradient steps at batch 1
        # (card, card with the plain attention, CPU) against float64
        # (profile_float64_phase, the readings behind PROFILE_GRAD_FLOOR)

1. prints the card (nvidia-smi) and turns TF32 off;
2. builds every CUDA kernel of the port from galerkin_transformer_torch/csrc
   (one nvcc per source, in parallel, into build/);
3. kernel phases at the serving shapes: each kernel against its plain
   PyTorch version on the same inputs, with its time, the plain version's,
   one PyTorch library call's as a yardstick, and the card's bound: the
   float32 ``fourier_chain`` (also against a float64 reference, to 1e-5
   of its largest entry) and ``galerkin_scores`` at the ex1 shapes,
   ``galerkin_scores`` again at the ex2 serving and training shapes (each
   also against a float64 reference, to 1e-5 of its largest entry, and
   timed with only its copies, only LayerNorm and only the product), and the
   bfloat16 tensor-core kernels ``galerkin_scores_bf16`` (ex1, ex2 serving
   and ex2 training shapes) and ``fourier_chain_bf16`` (ex1 serving shape,
   and timed at the training shape); the galerkin kernels (forward and
   backward) take a different pos for each sample; each galerkin forward exactly one device kernel per
   call, as a CUDA graph captured from the call holds them (``torch.profiler``
   has dropped short kernels); each kernel bit-equal on a
   second call, and each chain two device kernels per call (its layout
   prologue and the chain, no copy);
4. backward kernel phases: ``galerkin_scores_bwd`` and
   ``galerkin_scores_bwd_bf16`` at the ex2 training shape and the ex1 shape
   against their plain versions (and bit-equal on a second call; each
   runs exactly one device kernel per call without dpos and two with, as
   a CUDA graph of the call holds them), and the fourier attention backward at
   the training shape against ``fourier_attention_bwd_reference``: three
   ``fourier_chain`` launches in float32 (each sweep also against float64,
   to 1e-5 of its largest entry), three ``fourier_chain_mixed``
   launches (one float32 operand each, each bit-equal on a second call and
   two device kernels) for bfloat16 q, k, v; the float32 ``galerkin_scores``,
   ``galerkin_scores_bwd``, ``fourier_chain`` and the fourier backward
   again at the encoder profile's shapes (8, 4, 8192, 32, 1) and
   (32, 8192, 33), as above;
   wide phase: a galerkin and a fourier ``SimpleAttention`` with heads of
   d_k + pos_dim = 130 columns, wider than the kernels take, forward and
   backward on the card against the CPU, with no kernel launched (the JAX
   package's XLA route for such heads);
5. serving phase, the port's first main path: ``Predictor`` answers batches
   of 8 with the full-width ex1 SimpleTransformer (random weights from a
   seed), for fourier and galerkin attention at n = 8192 and n = 2048,
   timing each request on the host clock (numpy in, numpy out).  The first
   request of a shape runs eagerly and the forward is captured; every
   later request is a replay of that CUDA graph, whose kernel nodes must
   hold exactly one launch of the attention type's kernel per encoder
   layer (launches on this path: the graph's kernels times the replays).
   Outputs must be finite, of shape (8, n, 1), agree with the same weights
   run on the CPU through the plain path and with the model called eagerly
   on the card (bit for bit with cuDNN's deterministic algorithms), which
   is timed beside the replays, each with its device time, busy share and
   the memory the shape's graph holds; then the same with
   ``dtype=torch.bfloat16`` (the bfloat16 kernels, against the CPU's
   bfloat16 plain path), and a galerkin model with heads of 129 columns
   (no kernel);
   2D serving phase, the third main path: ``Predictor`` answers batches of 4
   with the full-width ex2 Darcy FourierTransformer2D (random weights from a
   seed, a normalizer, the Dirichlet boundary) at (n_f, n_c) = (141, 43) and
   (211, 71), in float32 and bfloat16: outputs finite, of shape
   (4, n_f, n_f, 1), zero on the boundary ring, agreeing with the CPU plain
   path (float32: to 1e-3 of how far the model's own part of the output
   varies over the grid, the normalizer undone; bfloat16: to 2^-6 of that
   part's largest entry), with exactly 6 launches of the matching galerkin
   kernel per request in the graph;
   ex4 serving phase, the fifth main path: ``Predictor`` answers batches of
   4 with the full-width ex4 FourierTransformer2DLite (862,049 parameters,
   a 10-step window on the 64² grid, float32) as above, with no kernel of
   the port in the graph;
6. training phase, the second main path: one ``train_step`` of the
   full-width ex1 model on a batch of 8 at n = 2048 from ``BurgersDataset``
   and ``DataLoader`` (synthetic Cole–Hopf data), on the card and on the
   CPU from the same seed, for both attention types: losses and every
   gradient must agree; then the median step time over timed steps, the
   grid-points/s and the device's busy share; each step must launch
   exactly 16 ``fourier_chain`` (fourier) or 4 ``galerkin_scores`` + 4
   ``galerkin_scores_bwd`` (galerkin); the same with
   ``dtype=torch.bfloat16`` (4 ``fourier_chain_bf16`` + 12
   ``fourier_chain_mixed``, or 4 ``galerkin_scores_bf16`` + 4
   ``galerkin_scores_bwd_bf16``);
   2D training phase, the fourth main path: one ``make_darcy_steps`` step of
   the full-width ex2 FourierTransformer2D on a batch of 4 from
   ``DarcyDataset`` and ``DataLoader`` (synthetic Darcy pairs at
   (n_f, n_c) = (211, 43)), on the card and on the CPU from the same seed
   with dropout off, in float32 and bfloat16: losses and every gradient
   must agree, with exactly 6 forward and 6 backward launches of the
   matching galerkin kernels; then timed steps with the config's dropout,
   and how far the bf16 gradients are from the f32 ones on the card and on
   the CPU; a diagnostic (outside the main path's counts) runs the card's
   bf16 step once more with ``galerkin_scores_bwd_bf16`` replaced by its
   plain version on the same CUDA inputs, then with the bf16 forward kernel
   replaced too, and prints those gaps;
   ex4 training phase: one ``make_ns_steps`` step of the full-width ex4
   model (a 10-step rollout and one backward through it, batch 4 from
   ``NavierStokesDatasetLite``, made by the torch generator on the card)
   on the card and on the CPU, dropout off, losses and every gradient
   agreeing; timed steps with the config's dropout; then the step through
   ``DeviceEpochRunner`` (the whole rollout and its backward one captured
   graph) against the eager host loop, as in item 7; no kernel launches;
7. device-loop phase, the training paths as the drivers run them by
   default: the ex1 step (both attention types, float32 and bfloat16) and
   the ex2 step (float32 and bfloat16) through ``DeviceEpochRunner`` on the
   training phases' datasets (shuffle and dropout off): two eager warm-up
   steps, then every step a replay of one CUDA graph, whose kernels must be
   exactly the step's launches (``LAUNCHES_PER_STEP``, read from the graph's
   kernel nodes); its per-step losses and final weights against as many
   eager host-loop steps from the same weights (bit-equal expected, the gap
   printed); the median step time inside the loop (epoch wall over its
   steps), the eager step time, the device time of a step and the busy
   share; launches on this path are the graph's kernels times the replays;
   recovery phase (``recovery_phase``): ``run_train`` of the full-width ex1
   galerkin step (f32, batch 8, n = 2048, cuDNN deterministic) in the device
   loop: the weights ×1e4 from the host between two blocks of 2 epochs, so
   that the next block spikes and rolls back; right after the rollback the
   Adam moments are zero, ``lr_scale`` is 0.5 and the graph is the one
   captured before it, every later step a replay, the losses finite; the
   run bit-equal to the same loop with eager steps, and with 1 epoch per
   host read to the eager host loop with the same poisoning; a resume from
   its best checkpoint for 2 epochs, and ``AdamPlateau`` with a controller
   that cuts the lr inside the run, each bit-equal to the eager host loop;
   then the step time in the loop for each optimizer, with the card;
8. driver phase: ``examples/ex1_burgers.py``, ``examples/ex2_darcy.py``,
   ``examples/ex4_navier_stokes.py`` (2 epochs each; ex4 on 20 trajectories
   made afresh, the training set by the torch generator on the card, the
   validation set by the host solver, each timed) and
   ``examples/ex3_darcy_inv.py`` (1 epoch) of the port, in-process, on the
   device loop (their default); then ex1 with ``--attention-type galerkin
   --rollback-on-spike 10 --scheduler plateau`` for 2 epochs and
   ``--resume-epoch 2`` for a third, ex1 with ``--attention-type softmax``
   and with ``--nonuniform --attention-type galerkin`` (2 epochs each), and
   ex4 with ``--scheduler plateau``, and
   ``examples/ex1_burgers_super_res.py`` forward (train n = 2048, validate
   n = 8192) and in reverse, 2 epochs each; their losses must be finite,
   the super-resolution runs must print their final line with the two
   resolutions, and the ex1 (all three), ex2 and ex4 best checkpoints must
   load into ``Predictor`` and serve a batch (ex2 with the normalizer saved
   in the checkpoint); the first ex1 checkpoint, written again as a JAX
   checkpoint, a reference ``torch.save`` file and a port checkpoint and
   read back by ``Predictor.from_checkpoint`` (which tells the kind by
   content), must serve bit for bit as it did;
9. ex1 variants phase (``ex1_variants_phase``), the rest of the ex1 model
   at full width (random weights): ``linear``, ``softmax``, ``cosine`` (f32
   and bf16) and ``official`` (the vanilla softmax stack, f32) served
   through ``Predictor`` at n = 8192 and 2048 as in item 5, with no kernel
   in their graphs (bf16 cosine against the CPU's float32 model, to
   ``TOL_SERVE_COSINE_BF16``); each one train step (dropout off) on the
   card against the CPU and through ``DeviceEpochRunner`` against the
   eager host loop, and so the galerkin step with its latents'
   orthogonality penalty; the galerkin and fourier steps (f32, bf16) on
   per-sample nonuniform meshes (``BurgersDataset(uniform=False)``), each
   against the CPU and in the device loop, with exactly the uniform steps'
   launches, and a nonuniform galerkin request served; masked
   ``SimpleAttention`` calls (fourier, softmax, causal with its key mask)
   on the card against the CPU, and causal with its norm against float64
   on its well-conditioned rows (``causal_witness``);
10. 2D variants phase (``variants_2d_phase``), the rest of the 2D model at
   the ex2 width (random weights): ``linear``, ``global``, ``softmax``,
   ``cosine`` and ``official`` (f32) and ``linear``, ``softmax`` and
   ``cosine`` (bf16) served at (n_f, n_c) = (141, 43) as in item 5 with no
   kernel in their graphs (bf16 cosine against the CPU's float32 model, to
   ``TOL_SERVE_COSINE_BF16_2D``), each one train step (dropout off) against the
   CPU and through ``DeviceEpochRunner`` against the eager host loop at
   (211, 43); galerkin and fourier (f32) with ``return_attn_weight`` and
   ``return_latent``, served with exactly the plain request's 6 kernel
   launches and its preds; ``causal`` raising on the card and the CPU (the
   2D model passes no mask); the phase's wall time;
11. checkpoints phase (``checkpoints_phase``): the reference's
   ``eval/torch_anchor_500ep.ckpt`` through ``Predictor.from_checkpoint`` on
   the card, its validation metric on the calibration's 100 validation
   fields (n = 2048, batches of 16) within 1 % of the reference's
   1.4932e-3, with ``galerkin_scores`` in every layer of its graphs;
12. generators phase (``generators_phase``): the multigrid Darcy solve
   (``data/synthetic_torch.py::darcy_mg``) of the same fields at 421² on
   the card and the CPU at a fixed count (2 cycles, tol 0, batch 4), to
   1e-4 of the largest entry, and its captured cycles bit-equal to eager
   ones; ``darcy_mg_torch`` of 16 samples at 421² through the residual
   gate (every sample below 0.05, float32 on the card and float64 on the
   host), eager and captured: seconds a sample, samples/s, cycles, the
   kernels of one captured cycle; Cole–Hopf at n = 8192 against the CPU;
13. ex2 at 421 (``darcy_421_phase``): ``examples/ex2_darcy.py`` at its
   defaults for 1 epoch on 32 samples made afresh by multigrid on the card
   (train and validation sets), each train step's graph exactly 6
   ``galerkin_scores`` and 6 ``galerkin_scores_bwd``;
14. graph phase (``graph_phase``): a GCN and a GAT ``SimpleTransformer`` at
   the ex1 width (galerkin) at n = 1024 and a GCN ``FourierTransformer2D``
   at (141, 43) on ``DarcyDataset``'s FEM edge features, each served with
   its edge features against the CPU (its galerkin launches exactly) and
   stepped against the CPU;
15. random-features phase (``random_features_phase``): the ex1-width
   ``RandomFourierTransformer``, favor and rfa, through
   ``DeviceEpochRunner`` against the eager loop, ω redrawn on the host
   before each step: a new ω every replay, the same sequence as the eager
   loop's;
16. decoder phase (``decoder_phase``): one ``GalerkinTransformerDecoderLayer``
   at the ex1 width (d 96, 1 head, FFN 192, per-head LN) at n = 8192, batch
   8, galerkin and fourier self-attention: a forward with exactly one
   ``galerkin_scores`` or ``fourier_chain`` against the CPU on the rows
   whose causal cross-attention is well conditioned (κ <= 100), that
   cross-attention against float64 on those rows (``causal_witness``, as
   in item 9), and one step (one
   ``galerkin_scores_bwd`` or three ``fourier_chain`` more) against the CPU;
17. profiles phase (``profiles_phase``): the four ``examples/*_memory_profile.py``
   drivers at their defaults (ex1 n = 8192 batch 4, ex2 (141, 43) and ex3
   (141, 36) batch 4, the encoder stack d 128, 4 heads, 4 layers, n = 8192,
   batch 8; the encoder's softmax batch cut if its reckoned eager peak
   passes half the card), each printing JAX's table: each row keeps the graph
   its timing replayed, the captured galerkin and fourier steps hold their
   kernels in every layer, every row's FLOPs equal the CPU's count, and
   the galerkin and fourier steps at batch 1 (the drivers' shapes and
   kernel instantiations but the batch) give the CPU's gradients, to
   ``TOL_PROFILE_GRAD`` with the ``PROFILE_GRAD_FLOOR`` floor;
18. eval phase (``eval_phase``): ``eval/ex1_burgers_eval.py`` on the
   reference's checkpoint within 1 % of 1.4932e-3 and
   ``eval/ex2_darcy_eval.py`` on the ex2 421 checkpoint, every request with
   ``galerkin_scores`` in every layer;
19. parallel phase (``parallel_phase``), the multi-device paths, each rank a
   process started by ``parallel.spawn`` (a rank that fails fails the
   phase): world 1 over NCCL, three full-width ex1 galerkin f32 steps with
   a mesh (n = 8192, batch 8) and ``Predictor(mesh=)`` requests, each equal
   to the same without a mesh (to 1e-6); then two ranks sharing the card
   over gloo on a 1 x 2 (data x seq) mesh: the ex1 galerkin model with
   ``seq_mesh`` served in f32 and bf16 at n = 8192 and the ex2 model at
   (211, 71) (5041 coarse tokens, padded to 5042), each against the
   one-process kernel path, with exactly the kernel's launches per layer
   on each rank, three f32 steps held to the one-process steps (losses
   2e-5, parameters rtol 1e-4 / atol 1e-5), and one bf16 step held to the
   one-process bf16 step at the bf16 train tolerances (its launches of
   ``galerkin_scores_bwd_bf16`` counted); each rank's local partial
   against the whole kernel, and the collectives' times;
20. prints one {"kernels": [...]} line (launches summed over the main
   paths), each phase's seconds, then the result line
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero.  Without a GPU it exits 1 and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import gc
import glob
import importlib
import importlib.util
import inspect
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from galerkin_transformer_torch import (FourierTransformer2D,  # noqa: E402
                                        FourierTransformer2DLite, Predictor,
                                        SimpleTransformer, load_config)
from galerkin_transformer_torch.serve import read_checkpoint  # noqa: E402
from galerkin_transformer_torch.data import (BurgersDataset, DarcyDataset,  # noqa: E402
                                             DataLoader, NavierStokesDatasetLite,
                                             darcy_grids, get_scaler_sizes, ns_grids)
from galerkin_transformer_torch.examples import (ex1_burgers,  # noqa: E402
                                                 ex1_burgers_random_fourier_features,
                                                 ex1_burgers_super_res, ex2_darcy,
                                                 ex3_darcy_inv, ex4_navier_stokes)
from galerkin_transformer_torch.examples import (encoder_memory_profile,  # noqa: E402
                                                 ex1_memory_profile, ex2_memory_profile,
                                                 ex3_memory_profile)
from galerkin_transformer_torch.eval import ex1_burgers_eval, ex2_darcy_eval  # noqa: E402
from galerkin_transformer_torch.models import GalerkinTransformerDecoderLayer  # noqa: E402
from galerkin_transformer_torch.utils.profiling import compiled_cost  # noqa: E402
from galerkin_transformer_torch.models.graph import GAT, GCN  # noqa: E402
from galerkin_transformer_torch.models.random_fourier import (  # noqa: E402
    redraw_random_features)
from galerkin_transformer_torch.train import (AdamOneCycle, AdamPlateau,  # noqa: E402
                                              DeviceEpochRunner, PlateauController,
                                              WeightedL2Loss, WeightedL2Loss2d,
                                              load_checkpoint, make_burgers_steps,
                                              make_darcy_steps, make_ns_steps, run_train,
                                              save_checkpoint, save_jax_checkpoint)
from galerkin_transformer_torch.utils import config as port_config  # noqa: E402
from galerkin_transformer_torch.data import synthetic_torch as ST  # noqa: E402
from galerkin_transformer_torch.ops.cuda import _build  # noqa: E402
from galerkin_transformer_torch.ops.cuda._graph import (launched_kernels,  # noqa: E402
                                                        wrapper_launches)
from galerkin_transformer_torch.ops.cuda import fourier as FC  # noqa: E402
from galerkin_transformer_torch.ops.cuda import galerkin as GS  # noqa: E402
from galerkin_transformer_torch.ops.attention import per_head_layer_norm  # noqa: E402
from galerkin_transformer_torch.models import layers as model_layers  # noqa: E402
from galerkin_transformer_torch.models.layers import SimpleAttention  # noqa: E402
from galerkin_transformer_torch.models.encoder import MultiHeadDotProductAttention  # noqa: E402

SEED = 0
BATCH = 8
RESOLUTIONS = (8192, 2048)      # the full 2^13 Burgers grid and subsample 4
REQUESTS = 5
ATTENTION_TYPES = ("fourier", "galerkin")
KERNEL_OF = {("fourier", None): "fourier_chain",
             ("galerkin", None): "galerkin_scores",
             ("fourier", torch.bfloat16): "fourier_chain_bf16",
             ("galerkin", torch.bfloat16): "galerkin_scores_bf16"}
DTYPES = (None, torch.bfloat16)     # the encoder's compute type; None is float32
BATCH_2D = 4
GRIDS_2D = ((141, 43), (211, 71))   # (n_f, n_c): the ex2 example's defaults on the
                                    # 421 grid (subsample 3 / 10), and the paper's fine setting
SPIN_CYCLES = 200_000_000     # ~0.1 s at 2 GHz: longer than queueing the timed calls

# float32 outside the tensor cores, dense bfloat16 on the tensor cores, and
# memory rate, at the full power limit (NVIDIA H100 data sheet)
PEAKS = {
    "H100 SXM": dict(f32_flops=67e12, bf16_flops=989e12, bytes=3.35e12),
    "H100 PCIe": dict(f32_flops=51e12, bf16_flops=756e12, bytes=2.0e12),
    "H100 NVL": dict(f32_flops=60e12, bf16_flops=835e12, bytes=3.9e12),
}

# kernel vs plain version on the same card: float32 sums over n = 8192 terms
# taken in another order; measured relative to the largest entry
TOL_GALERKIN = 1e-4
TOL_FOURIER = 1e-4
# the float32 fourier_chain against a float64 reference of the same chain, of
# its largest entry: the plain float32 version is about 1e-6 off, one-pass
# TF32 (10 significand bits) about 1e-4
TOL_FOURIER_F64 = 1e-5
# the float32 galerkin_scores against a float64 reference, of its largest
# entry: the plain float32 version is about 3e-7 off, one bfloat16 pass about
# 1e-3 (tests/test_torch_galerkin_split.py)
TOL_GALERKIN_F64 = 1e-5
# a bfloat16 kernel vs its plain version: both round the same float32 values
# to bfloat16 and sum the same products in float32, in another order; a value
# on a rounding boundary may round the other way (one bfloat16 step, 2^-8, of
# one term)
TOL_BF16_KERNEL = 1e-3
# served predictions vs the CPU plain path: four encoder layers and the DFT
# regressor, each a float32 sum of up to 8192 terms in another order
TOL_SERVE = 1e-3
# bfloat16 serving vs the CPU's bfloat16 plain path: every matrix product of
# the encoder (cuBLAS there, oneDNN here) sums in another order before it
# rounds to bfloat16, so activations differ by single bfloat16 steps (2^-8)
# that add up over the layers: four steps of the largest output
TOL_SERVE_BF16 = 2.0 ** -6
# bfloat16 cosine serving vs the CPU's float32 model of the same weights, of
# its largest output: cosine weights are not normalized over n, so each
# output sums n signed products of weights rounded to bfloat16, and the bf16
# model lies further from float32 than four steps.  Readings of
# ``--cosine-bf16`` on an H100 (seeds 0-3, n = 8192 and 2048): the CPU's
# bf16 model 1.22e-2 to 1.047e-1 from float32, the card's 1.21e-2 to
# 1.063e-1, within 2.4e-3 of the CPU's on each input; the bound is the
# largest reading ×1.25, rounded up to 1e-2
TOL_SERVE_COSINE_BF16 = 0.14
# the same for the 2D model (ex2 width at (141, 43)), of the largest entry of
# the float32 model's own part: ``cosine_bf16_2d_readings`` on an H100 (seeds
# 0-3): the CPU's bf16 model 1.75e-2 to 8.68e-2 from float32, the card's
# 1.81e-2 to 8.28e-2, the card's 9.4e-3 to 3.88e-2 from the CPU's bf16 (too
# far to hold it to TOL_SERVE_BF16); the smoke's own draw read 2.52e-1.  The
# bound is the largest reading ×1.25, rounded up to 1e-2
TOL_SERVE_COSINE_BF16_2D = 0.32
# one train step on the card vs the CPU: losses relative, gradients against
# the largest entry of each (a forward and a backward through four layers)
TOL_TRAIN_LOSS = 1e-4
TOL_TRAIN_GRAD = 1e-3
SUBSAMPLE = 4                  # the ex1 default
TRAIN_N = 8192 // SUBSAMPLE
TRAIN_SAMPLES = 64
TRAIN_STEPS = 12
LAUNCHES_PER_STEP = {
    ("fourier", None): {"fourier_chain": 16},
    ("galerkin", None): {"galerkin_scores": 4, "galerkin_scores_bwd": 4},
    ("fourier", torch.bfloat16): {"fourier_chain_bf16": 4, "fourier_chain_mixed": 12},
    ("galerkin", torch.bfloat16): {"galerkin_scores_bf16": 4, "galerkin_scores_bwd_bf16": 4}}
# the bfloat16 backward of galerkin_scores vs its plain version, which rounds at
# the same places: the outputs are float32 values rounded to bfloat16, from
# sums taken in another order, and the rounded products dK', dV' feed every
# later sum: two bfloat16 steps (2^-8) of each gradient's largest entry
TOL_BF16_BWD = 2 * 2.0 ** -8
# fourier_chain_mixed vs the plain version when C is the float32 operand:
# nothing is rounded to bfloat16, only the float32 sums differ in order
TOL_MIXED_F32 = 1e-4
# one bfloat16 train step on the card vs the CPU: the encoder's products round
# to bfloat16 after sums in another order, forward and backward.  The loss is
# formed by the float32 decoder and moves little (measured <= 7e-5).  A
# gradient moves by a few bfloat16 steps (2^-8) of its largest entry per
# layer; the per-head LN biases, sums over all rows that cancel, move most
# (measured 3.3e-2 of the largest entry): 16 steps
TOL_TRAIN_LOSS_BF16 = 1e-3
TOL_TRAIN_GRAD_BF16 = 2.0 ** -4
# the 2D train step: (n_f, n_c) of a 211 grid with subsample_attn 5, which the
# host generator (a sparse direct solve per sample) makes in seconds
TRAIN_2D = dict(n_grid_fine=211, subsample_nodes=1, subsample_attn=5,
                n_samples_synthetic=10)
TRAIN_2D_STEPS = 8
# device-loop phase: epochs of each runner (ex1: 4 steps an epoch, ex2: 2, ex4: 5), the
# first with the eager warm-up and the capture; the rest time the replays
LOOP_EPOCHS = {"ex1": 8, "ex2": 12, "ex4": 4}
# the device loop against as many eager host-loop steps from the same weights:
# float32 relative (losses; each weight against its tensor's largest entry)
TOL_LOOP = 1e-5
# (B, H, n, d_k, p) of the galerkin kernels on the main paths: ex1, ex2 serving
# at (n_f, n_c) = (211, 71), ex2 training
EX1_SHAPE = (BATCH, 1, RESOLUTIONS[0], 96, 1)
EX2_SHAPE = (BATCH_2D, 4, GRIDS_2D[1][1] ** 2, 32, 2)   # (4, 4, 5041, 32, 2)
EX2_TRAIN_SHAPE = (BATCH_2D, 4, ((TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_attn"]
                                 + 1) ** 2, 32, 2)   # (4, 4, 1849, 32, 2)
NO_DROPOUT = dict(dropout=0.0, downscaler_dropout=0.0, upscaler_dropout=0.0,
                  ffn_dropout=0.0, encoder_dropout=0.0, decoder_dropout=0.0)
# a served ex1 galerkin model whose heads are wider than the kernels take:
# d_k + pos_dim = 128 + 1
WIDE_EX1 = dict(attention_type="galerkin", n_hidden=256, n_head=2, dim_feedforward=512)
# ex4 (config.yml:121-146) at the JAX driver's defaults: the 64² grid, a
# 10-step input window and a 10-step rollout; the training phases' set is
# made by the torch generator on the card (above 16·64² points)
EX4_PARAMS = 862049
EX4_GRID = 64
EX4_WINDOW = 10
EX4_SAMPLES = 20


def peaks_for(name: str) -> dict:
    if "H100" not in name:
        raise RuntimeError(f"no peak rates recorded for {name!r}")
    if "PCIe" in name:
        return PEAKS["H100 PCIe"]
    if "NVL" in name:
        return PEAKS["H100 NVL"]
    return PEAKS["H100 SXM"]


def time_ms(fn, iters: int) -> float:
    """Device time of one fn() call: the mean over `iters` calls queued back
    to back behind a device-side spin, so the host's launch cost (Python,
    ctypes) is hidden and not counted."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, tries: int = 3) -> list:
    """Names of the device kernels that one fn() call runs, as
    ``torch.profiler`` names them (to pick a call's kernels out of a profile;
    `kernels_per_call` counts them), after a warm-up call; copies and fills
    are not counted.  The profiler has been seen to drop a kernel's record,
    so the longest of `tries` profiles is taken."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        runs.append([e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "emcpy" not in e.name and "emset" not in e.name])
    return max(runs, key=len)


def ptxas_summary(log: str) -> list:
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name with its
    template arguments (demangled by the toolkit's ``cu++filt``), its
    registers, and its spill stores and loads."""
    entries, name, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            entries.append((name, regs.group(1) if regs else "?", spill))
    names = demangled([e[0] for e in entries])
    return [f"{shown}: {regs} registers, {spill}"
            for shown, (_, regs, spill) in zip(names, entries)]


def demangled(names: list) -> list:
    """Kernel `names` demangled by the toolkit's ``cu++filt``, without their
    parameter lists."""
    if not names:
        return []
    filt = os.path.join(os.path.dirname(os.path.realpath(_build._nvcc())), "cu++filt")
    return subprocess.run([filt, "-p", *names], capture_output=True, text=True,
                          check=True).stdout.splitlines()


def kernels_per_call(fn) -> list:
    """The demangled names of the device kernels that one fn() call
    launches, in launch order (``launched_kernels``: the kernel nodes of a
    CUDA graph captured from the call)."""
    return demangled(launched_kernels(fn))


def max_err(got, ref):
    return (got - ref).abs().max().item(), ref.abs().max().item()


def chain_float64(a, b, c, row_block: int = 2048):
    """(A Bᵀ) C per bh in float64, rows taken `row_block` at a time as
    `fourier_chain_reference` takes them."""
    bh, r, _ = a.shape
    out = torch.empty((bh, r, c.shape[-1]), dtype=torch.float64, device=a.device)
    bt, cd = b.double().transpose(1, 2), c.double()
    for r0 in range(0, r, row_block):
        out[:, r0:r0 + row_block] = torch.matmul(
            torch.matmul(a[:, r0:r0 + row_block].double(), bt), cd)
    return out


def float64_check(tag, got, plain, ops):
    """The float32 chain `got` and its plain version `plain` on operands
    `ops` against `chain_float64`: the kernel within TOL_FOURIER_F64 of the
    largest entry.  Returns the kernel's error of max|ref|."""
    ref = chain_float64(*ops)
    scale = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item() / scale
    plain_err = (plain.double() - ref).abs().max().item() / scale
    print(f"  {tag} vs float64: kernel {err:.3e}, plain float32 {plain_err:.3e} of "
          f"max|ref| (tol {TOL_FOURIER_F64:.0e})")
    if not err <= TOL_FOURIER_F64:
        raise AssertionError(f"{tag} is {err:.3e} of max|ref| from float64")
    return err


def scores_float64(k, v, pos, params, eps):
    """S = [pos, LN_K(K)]ᵀ[pos, LN_V(V)] per (b, h) in float64 from the
    same float32 inputs."""
    def ln(x, scale, bias):
        x = x.double()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + eps) * scale.double()[:, None]
                + bias.double()[:, None])
    b, h, n, _ = k.shape

    def cat(x):
        if pos is None:
            return x
        return torch.cat([pos.double()[:, None].expand(b, h, n, pos.shape[-1]), x], -1)
    return torch.matmul(cat(ln(k, *params[:2])).transpose(-2, -1), cat(ln(v, *params[2:])))


def scores_float64_err(got, args) -> float:
    """The float32 scores `got` of `galerkin_scores(*args)` against
    `scores_float64`, of its largest entry."""
    k, v, pos, *params, eps = args
    ref = scores_float64(k, v, pos, params, eps)
    return ((got.double() - ref).abs().max() / ref.abs().max()).item()


def _tensor(a, dev, dtype=None):
    t = torch.from_numpy(a.astype(np.float32)).to(dev)
    return t if dtype is None else t.to(dtype)


def galerkin_inputs(rng, dev, shape, dtype):
    """k, v (B, H, n, d_k) and pos (B, n, p) of `dtype`, and the four float32
    LN parameters (H, d_k).  Each sample has its own coordinates, as on a
    nonuniform mesh, so a kernel that read one sample's pos for all fails."""
    b, h, n, d_k, p = shape
    k, v = (_tensor(rng.standard_normal((b, h, n, d_k)), dev, dtype) for _ in range(2))
    if p == 1:   # sorted random nodes on [0, 1], both ends pinned
        pos = np.sort(rng.random((b, n, 1)), axis=1)
        pos[:, 0], pos[:, -1] = 0.0, 1.0
    else:   # the nodes of a square grid, as the 2D model passes them, scaled per sample
        side = math.isqrt(n)
        pos = darcy_grids(side, side)[0][None] * (0.5 + rng.random((b, 1, 1)))
    params = [_tensor(1 + 0.1 * rng.standard_normal((h, d_k)), dev),
              _tensor(0.1 * rng.standard_normal((h, d_k)), dev),
              _tensor(1 + 0.1 * rng.standard_normal((h, d_k)), dev),
              _tensor(0.1 * rng.standard_normal((h, d_k)), dev)]
    return k, v, _tensor(pos, dev, dtype), params


def galerkin_phase(rng, dev, peak, shape=EX1_SHAPE, dtype=None, eps=1e-5):
    """`galerkin_scores` (float32) or `galerkin_scores_bf16` at
    (B, H, n, d_k, p): against the plain version, bit-equal run to run, timed."""
    b, h, n, d_k, p = shape
    d_eff = d_k + p
    bf16 = dtype == torch.bfloat16
    name = "galerkin_scores_bf16" if bf16 else "galerkin_scores"
    tol = TOL_BF16_KERNEL if bf16 else TOL_GALERKIN
    k, v, pos, params = galerkin_inputs(rng, dev, shape, dtype)
    args = (k, v, pos, *params, eps)
    counter = COUNTERS[name]
    before = counter.launches
    got = GS.galerkin_scores(*args)
    if counter.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch")
    ref = GS.galerkin_scores_reference(*args)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    print(f"{name} (B,H,n,d_k,p)=({b},{h},{n},{d_k},{p}) eps={eps:.0e}: "
          f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={err / scale:.3e} tol={tol:.0e}")
    if not err <= tol * scale:
        raise AssertionError(f"{name} disagrees with its plain version")
    if not bf16:   # the six part products keep float32 accuracy
        err64 = scores_float64_err(got, args)
        plain64 = scores_float64_err(ref, args)
        print(f"  vs float64: kernel {err64:.3e}, plain float32 {plain64:.3e} of max|ref| "
              f"(tol {TOL_GALERKIN_F64:.0e})")
        if not err64 <= TOL_GALERKIN_F64:
            raise AssertionError(f"{name} is {err64:.3e} of max|ref| from float64")
    again = GS.galerkin_scores(*args)
    if not torch.equal(got, again):
        raise AssertionError(f"{name} is not deterministic run to run")
    # one launch: its CTAs sum the partials themselves
    names = kernels_per_call(lambda: GS.galerkin_scores(*args))
    print(f"  {len(names)} device kernel(s) per call (CUDA graph): "
          f"{[n_[:40] for n_ in names]}")
    if len(names) != 1:
        raise AssertionError(f"{name} ran {len(names)} device kernels per call, expected 1")
    if not bf16:
        stage_split(args)

    ms = time_ms(lambda: GS.galerkin_scores(*args), 50)
    plain_ms = time_ms(lambda: GS.galerkin_scores_reference(*args), 20)
    ph = pos[:, None].expand(b, h, n, p)
    kc = torch.cat([ph, per_head_layer_norm(k, *params[:2])], -1)
    vc = torch.cat([ph, per_head_layer_norm(v, *params[2:])], -1)
    library_ms = time_ms(lambda: torch.matmul(kc.transpose(-2, -1), vc), 50)
    size = 2 if bf16 else 4
    nbytes = (size * (2 * b * h * n * d_k + b * n * p)
              + 4 * (4 * h * d_k + b * h * d_eff * d_eff))
    product, ln = 2 * b * h * n * d_eff * d_eff, 2 * 8 * b * h * n * d_k
    # a float32 product runs as six bfloat16 passes on the tensor cores, the
    # cheapest form the card has at float32 accuracy (its float32 rate outside
    # the tensor cores gives the bound printed beside it); LN at the float32 rate
    passes = 1 if bf16 else 6
    flops = passes * product + ln * peak["bf16_flops"] / peak["f32_flops"]
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/galerkin.py:46",
               shape=list(shape), max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(nbytes, int(flops), peak, "bf16_flops"))
    cuda_cores = "" if bf16 else (
        f", CUDA-core bound {bound(nbytes, product + ln, peak)['bound_ms']:.5f} ms")
    print(f"  {ms:.4f} ms, plain {plain_ms:.4f} ms, library (matmul of the normalised "
          f"concatenations) {library_ms:.4f} ms, bound {res['bound_ms']:.5f} ms "
          f"({res['bound_by']}{'' if bf16 else ', six bf16 passes'}){cuda_cores}")
    return res


def stage_split(args, iters: int = 50):
    """The float32 forward's time with only its copies and the sum over the
    splits, with LayerNorm alone, with the product alone (on what the tiles
    hold: not S) and whole (``GS.WORK_LN``, ``GS.WORK_PRODUCT``)."""
    times = {what: time_ms(lambda work=work: GS._scores_forward(*args, work=work), iters)
             for what, work in (("copies", 0), ("LN", GS.WORK_LN),
                                ("product", GS.WORK_PRODUCT),
                                ("whole", GS.WORK_LN | GS.WORK_PRODUCT))}
    print("  stages: " + ", ".join(f"{what} {ms:.4f} ms" for what, ms in times.items()))
    return times


def stage_sweep_phase(ns=(64, 1024, 2048, 4096, 8192, 16384)) -> list:
    """`stage_split` of the float32 forward at the ex1 width (batch 8,
    d_k 96, p 1) over n (``--stage-sweep``): between two n past the 50 MB
    L2 the difference is the time of the added 64-row chunks, and n = 64 is
    one chunk of one CTA per bh (no sum over splits)."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = []
    for n in ns:
        shape = (BATCH, 1, n, 96, 1)
        k, v, pos, params = galerkin_inputs(rng, dev, shape, None)
        per_split, splits = GS._occupancy_splits("galerkin_scores", BATCH, n, 96, 1, dev)
        print(f"galerkin_scores (B,H,n,d_k,p)={shape}: {splits} splits of {per_split} rows")
        rows.append(dict(shape=list(shape), splits=splits,
                         **stage_split((k, v, pos, *params, 1e-5))))
    return rows


def fourier_phase(rng, dev, peak, dtype=None, shape=(BATCH, RESOLUTIONS[0], 97)):
    """`fourier_chain` (float32) or `fourier_chain_bf16` at (BH, n, d), by
    default the ex1 shape (d = 96 + the pos column)."""
    bh, n, d = shape
    bf16 = dtype == torch.bfloat16
    name = "fourier_chain_bf16" if bf16 else "fourier_chain"
    tol = TOL_BF16_KERNEL if bf16 else TOL_FOURIER
    a, b, c = (_tensor(rng.standard_normal((bh, n, d)), dev, dtype) for _ in range(3))
    counter = COUNTERS[name]
    before = counter.launches
    got = FC.fourier_chain(a, b, c)
    if counter.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch")
    ref = FC.fourier_chain_reference(a, b, c)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref)
    print(f"{name} (BH,R=M,d)=({bh},{n},{d}): max_abs_err={err:.3e} "
          f"max|ref|={scale:.3e} rel={err / scale:.3e} tol={tol:.0e}")
    if not err <= tol * scale:
        raise AssertionError(f"{name} disagrees with its plain version")
    if not bf16:
        float64_check(name, got, ref, (a, b, c))
    if not torch.equal(got, FC.fourier_chain(a, b, c)):
        raise AssertionError(f"{name} is not deterministic run to run")
    check_chain_kernels(name, lambda: FC.fourier_chain(a, b, c))

    ms = time_ms(lambda: FC.fourier_chain(a, b, c), 5)
    plain_ms = time_ms(lambda: FC.fourier_chain_reference(a, b, c), 3)
    library_ms = time_ms(lambda: torch.matmul(torch.matmul(a, b.transpose(1, 2)), c), 3)
    # a, b, c read once, out (float32) written once.  A float32 product runs
    # as six bfloat16 passes on the tensor cores, the cheapest form the card
    # has at float32 accuracy (its float32 rate outside the tensor cores gives
    # the bound printed beside it)
    nbytes = (2 if bf16 else 4) * (bh * n * d * 3) + 4 * bh * n * d
    flops = 2 * bh * n * n * (d + d)
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/fourier.py:31",
               shape=[bh, n, d], max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(nbytes, flops * (1 if bf16 else 6), peak, "bf16_flops"))
    cuda_cores = "" if bf16 else (
        f", CUDA-core bound {bound(nbytes, flops, peak)['bound_ms']:.5f} ms")
    print(f"  {ms:.4f} ms, plain {plain_ms:.4f} ms, library ((a@b^T)@c, two matmuls) "
          f"{library_ms:.4f} ms, bound {res['bound_ms']:.5f} ms ({res['bound_by']}"
          f"{'' if bf16 else ', six bf16 passes'}){cuda_cores}")
    if bf16:   # the forward of the bfloat16 train step (printed, not in the line)
        n = TRAIN_N
        a, b, c = (_tensor(rng.standard_normal((bh, n, d)), dev, dtype) for _ in range(3))
        err, scale = max_err(FC.fourier_chain(a, b, c), FC.fourier_chain_reference(a, b, c))
        if not err <= tol * scale:
            raise AssertionError(f"{name} disagrees with its plain version at n = {n}")
        ms = time_ms(lambda: FC.fourier_chain(a, b, c), 20)
        plain_ms = time_ms(lambda: FC.fourier_chain_reference(a, b, c), 20)
        library_ms = time_ms(lambda: torch.matmul(torch.matmul(a, b.transpose(1, 2)), c), 20)
        b_ = bound(2 * bh * n * d * 3 + 4 * bh * n * d, 2 * bh * n * n * (d + d), peak,
                   "bf16_flops")
        print(f"{name} (BH,R=M,d)=({bh},{n},{d}): rel={err / scale:.3e}; {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, bound "
              f"{b_['bound_ms']:.5f} ms ({b_['bound_by']})")
    return res


def check_chain_kernels(name, call):
    """A chain call runs two device kernels (a CUDA graph of the call holds
    two): its layout prologue and the chain, no copy of an operand."""
    names = kernels_per_call(call)
    print(f"  {name}: {len(names)} device kernels per call (CUDA graph): "
          f"{[n_[:60] for n_ in names]}")
    if len(names) != 2 or "layout_kernel" not in names[0] or "chain_kernel" not in names[1]:
        raise AssertionError(f"{name} ran {names} per call, expected the layout prologue "
                             f"and the chain")


def galerkin_bwd_phase(rng, dev, peak, shape=EX1_SHAPE, dtype=None, eps=1e-5):
    """`galerkin_scores_bwd` (float32) or `galerkin_scores_bwd_bf16` at
    (B, H, n, d_k, p): against the plain version, bit-equal run to run, timed."""
    b, h, n, d_k, p = shape
    d_eff = d_k + p
    bf16 = dtype == torch.bfloat16
    name = "galerkin_scores_bwd_bf16" if bf16 else "galerkin_scores_bwd"
    tol = TOL_BF16_BWD if bf16 else TOL_GALERKIN
    k, v, pos, params = galerkin_inputs(rng, dev, shape, dtype)
    ds = _tensor(rng.standard_normal((b, h, d_eff, d_eff)), dev)
    args = (k, v, pos, *params, ds, eps)
    counter = COUNTERS[name]
    before = counter.launches
    got = GS.galerkin_scores_bwd(*args)
    if counter.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch")
    ref = GS.galerkin_scores_bwd_reference(*args)
    torch.cuda.synchronize()
    errs = []
    for gname, g, r in zip(("dk", "dv", "dpos", "dscale_k", "dbias_k", "dscale_v",
                            "dbias_v"), got, ref):
        # the bfloat16 kernel writes its outputs rounded once to bfloat16
        r = r.bfloat16().float() if bf16 else r
        err, scale = max_err(g.float(), r)
        errs.append(err)
        print(f"{name} {gname}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
              f"rel={err / scale:.3e} tol={tol:.1e}")
        if not err <= tol * scale:
            raise AssertionError(f"{name} {gname} disagrees with its plain version")
    again = GS.galerkin_scores_bwd(*args)
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError(f"{name} is not deterministic run to run")

    # one device kernel per call; a second one sums dpos over heads
    for need_dpos, want in ((False, 1), (True, 2)):
        names = kernels_per_call(lambda: GS.galerkin_scores_bwd(*args, need_dpos=need_dpos))
        print(f"{name} need_dpos={need_dpos}: {len(names)} device kernel(s) per call "
              f"(CUDA graph): {[n_[:40] for n_ in names]}")
        if len(names) != want:
            raise AssertionError(f"{name} ran {len(names)} device kernels per call with "
                                 f"need_dpos={need_dpos}, expected {want}")
    # timed as the training path calls it: positions need no gradient
    ms = time_ms(lambda: GS.galerkin_scores_bwd(*args, need_dpos=False), 50)
    plain_ms = time_ms(lambda: GS.galerkin_scores_bwd_reference(*args), 20)
    ph = pos[:, None].expand(b, h, n, p)
    kc = torch.cat([ph, per_head_layer_norm(k, *params[:2])], -1)
    vc = torch.cat([ph, per_head_layer_norm(v, *params[2:])], -1)
    dsl = ds.to(k.dtype)
    library_ms = time_ms(lambda: (torch.matmul(kc, dsl),
                                  torch.matmul(vc, dsl.transpose(-2, -1))), 50)
    # read k, v, pos, dS and the LN parameters; write dk, dv and their gradients
    size = 2 if bf16 else 4
    nbytes = (size * (4 * b * h * n * d_k + b * n * p)
              + 4 * (b * h * d_eff * d_eff + 8 * h * d_k))
    # the two row-by-matrix products (on the tensor cores for bfloat16), and LN
    # forward (7 flops an element) and backward with the affine sums (11) for
    # k and for v
    flops = 4 * b * h * n * d_eff * d_eff + 2 * 18 * b * h * n * d_k
    res = dict(name=name, route="cuda",
               source=f"galerkin_transformer_torch/csrc/{name}.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/galerkin.py:208",
               shape=list(shape), max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(nbytes, flops, peak, "bf16_flops" if bf16 else "f32_flops"))
    print(f"{name} (B,H,n,d_k,p)=({b},{h},{n},{d_k},{p}) eps={eps:.0e}: {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, library (two matmuls) {library_ms:.4f} ms, "
          f"bound {res['bound_ms']:.5f} ms ({res['bound_by']})")
    return res


def fourier_bwd_phase(rng, dev, peak, shape=(BATCH, TRAIN_N, 97)):
    """The backward of fourier attention at (BH, n, d), by default the ex1
    training shape: three fourier_chain launches, against
    fourier_attention_bwd_reference."""
    bh, n, d = shape
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    q, k, v, g = (t(rng.standard_normal((bh, 1, n, d))) for _ in range(4))
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(FC.fourier_attention_tiled(*xs), xs, g)
    ref = FC.fourier_attention_bwd_reference(q, k, v, g)
    torch.cuda.synchronize()
    for name, a, r in zip(("dQ", "dK", "dV"), got, ref):
        err, scale = max_err(a, r)
        print(f"fourier backward {name} (BH,n,d)=({bh},{n},{d}): max_abs_err={err:.3e} "
              f"max|ref|={scale:.3e} rel={err / scale:.3e} tol={TOL_FOURIER:.0e}")
        if not err <= TOL_FOURIER * scale:
            raise AssertionError(f"fourier backward {name} disagrees with its plain version")
    flat = [x.reshape(bh, n, d) for x in (q, k, v, g)]
    qf, kf, vf, gf = flat
    sweeps = ((gf, vf, kf), (vf, gf, qf), (kf, qf, gf))
    for name, ops in zip(("dQ", "dK", "dV"), sweeps):
        float64_check(f"fourier backward sweep {name} (unscaled)", FC.fourier_chain(*ops),
                      FC.fourier_chain_reference(*ops), ops)
    ms = time_ms(lambda: [FC.fourier_chain(*o) for o in sweeps], 3)
    plain_ms = time_ms(lambda: FC.fourier_attention_bwd_reference(q, k, v, g), 3)
    library_ms = time_ms(lambda: [torch.matmul(torch.matmul(a, b.transpose(1, 2)), c)
                                  for a, b, c in sweeps], 3)
    nbytes, flops = 3 * 4 * (bh * n * d * 4), 3 * 2 * bh * n * n * (d + d)
    b_ = bound(nbytes, 6 * flops, peak, "bf16_flops")
    print(f"fourier backward, three fourier_chain launches (BH,n,d)=({bh},{n},{d}): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (2 matmuls x 3) "
          f"{library_ms:.4f} ms, bound {b_['bound_ms']:.4f} ms ({b_['bound_by']}, six bf16 "
          f"passes), CUDA-core bound {bound(nbytes, flops, peak)['bound_ms']:.4f} ms")


def fourier_bwd_bf16_phase(rng, dev, peak):
    """The backward of fourier attention with bfloat16 q, k, v and a float32
    gradient at the training shape: three `fourier_chain_mixed` launches.
    Each sweep against `fourier_chain_reference` on the same operands, the
    three gradients against `fourier_attention_bwd_reference`, timed
    together (they are one backward)."""
    bh, n, d = BATCH, TRAIN_N, 97
    bf16 = torch.bfloat16
    q, k, v = (_tensor(rng.standard_normal((bh, 1, n, d)), dev, bf16) for _ in range(3))
    g = _tensor(rng.standard_normal((bh, 1, n, d)), dev)
    qf, kf, vf, gf = (x.reshape(bh, n, d) for x in (q, k, v, g))
    sweeps = {"dQ": (gf, vf, kf), "dK": (vf, gf, qf), "dV": (kf, qf, gf)}
    counter = COUNTERS["fourier_chain_mixed"]
    errs = []
    for name, ops in sweeps.items():
        before = counter.launches
        got = FC.fourier_chain_mixed(*ops)
        if counter.launches != before + 1:
            raise AssertionError("fourier_chain_mixed did not count its launch")
        ref = FC.fourier_chain_reference(*ops)
        torch.cuda.synchronize()
        err, scale = max_err(got, ref)
        # what rounding the float32 operand to bfloat16 would have cost
        rounded = [x.bfloat16().float() if x.dtype == torch.float32 else x for x in ops]
        far = (FC.fourier_chain_reference(*rounded) - ref).abs().max().item()
        tol = TOL_MIXED_F32 if name == "dV" else TOL_BF16_KERNEL
        types = ",".join("f32" if x.dtype == torch.float32 else "bf16" for x in ops)
        print(f"fourier_chain_mixed sweep {name} ({types}) (BH,n,d)=({bh},{n},{d}): "
              f"max_abs_err={err:.3e} max|ref|={scale:.3e} rel={err / scale:.3e} "
              f"tol={tol:.0e}; a bfloat16-rounded float32 operand would be "
              f"{far / scale:.3e} off")
        if not err <= tol * scale:
            raise AssertionError(f"fourier_chain_mixed sweep {name} disagrees with its "
                                 f"plain version")
        if not torch.equal(got, FC.fourier_chain_mixed(*ops)):
            raise AssertionError(f"fourier_chain_mixed sweep {name} is not deterministic")
        check_chain_kernels(f"fourier_chain_mixed sweep {name}",
                            lambda ops=ops: FC.fourier_chain_mixed(*ops))
        errs.append(err)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    before = counter.launches
    got = torch.autograd.grad(FC.fourier_attention_tiled(*xs), xs, g.to(bf16))
    if counter.launches != before + 3:
        raise AssertionError("the bfloat16 fourier backward did not launch "
                             "fourier_chain_mixed three times")
    ref = FC.fourier_attention_bwd_reference(q, k, v, g.to(bf16))
    for name, a, r in zip(sweeps, got, ref):
        err, scale = max_err(a.float(), r.float())
        print(f"fourier bf16 backward {name}: max_abs_err={err:.3e} max|ref|={scale:.3e} "
              f"(both rounded to bfloat16 at the end; tol one unit in the last place "
              f"of the largest entry, 2^-7)")
        if not err <= 2.0 ** -7 * scale:
            raise AssertionError(f"fourier bf16 backward {name} disagrees")

    ms = time_ms(lambda: [FC.fourier_chain_mixed(*o) for o in sweeps.values()], 5)
    each = [time_ms(lambda o=o: FC.fourier_chain_mixed(*o), 5) for o in sweeps.values()]
    plain_ms = time_ms(lambda: [FC.fourier_chain_reference(*o) for o in sweeps.values()], 3)
    as_f32 = [[x.float() for x in o] for o in sweeps.values()]
    library_ms = time_ms(lambda: [torch.matmul(torch.matmul(a, b.transpose(1, 2)), c)
                                  for a, b, c in as_f32], 3)
    # each sweep reads two bfloat16 operands and one float32 one and writes
    # float32.  Operations: a product of two bfloat16 operands is one pass on the
    # tensor cores; a product with one float32 operand is counted as three
    # bfloat16 passes and one with two float32 operands (the float32 score tile
    # times the float32 gradient) as six, the cheapest forms the card has at
    # float32 accuracy (its float32 rate outside the tensor cores would give a
    # bound that the tensor cores beat)
    product = 2 * bh * n * n * d
    flops = (3 + 1) * product + (3 + 1) * product + (1 + 6) * product
    nbytes = 3 * (2 * 2 * bh * n * d + 4 * bh * n * d + 4 * bh * n * d)
    res = dict(name="fourier_chain_mixed", route="cuda",
               source="galerkin_transformer_torch/csrc/fourier_chain_mixed.cu",
               replaces="galerkin_transformer_tpu/ops/pallas/fourier.py:142",
               shape=[bh, n, d], max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(nbytes, flops, peak, "bf16_flops"))
    print(f"fourier bf16 backward, three fourier_chain_mixed launches (BH,n,d)=({bh},{n},{d}): "
          f"{ms:.4f} ms (dQ {each[0]:.4f}, dK {each[1]:.4f}, dV {each[2]:.4f}), plain "
          f"{plain_ms:.4f} ms, library (2 float32 matmuls x 3) {library_ms:.4f} ms, bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']}; {flops / 1e9:.1f} GFLOP as bfloat16 "
          f"passes)")
    return res


def wide_phase(rng, dev):
    """Heads wider than the kernels take (d_k + pos_dim = 130): one galerkin
    (per-head LN) and one fourier `SimpleAttention`, forward and backward in
    train mode, on the card and on the CPU from the same weights.  They take
    the JAX package's XLA route, so no kernel may launch; outputs and every
    gradient agree to 1e-4 of their largest entry (float32 sums in another
    order)."""
    b, n, d_model, pos_dim = 4, TRAIN_N, 128, 2
    arrays = [rng.standard_normal((b, n, d_model)).astype(np.float32) for _ in range(4)]
    pos = rng.uniform(0, 1, (b, n, pos_dim)).astype(np.float32)
    for attention_type in ATTENTION_TYPES:
        results = []
        for device in (dev, "cpu"):
            layer = SimpleAttention(n_head=1, d_model=d_model, pos_dim=pos_dim,
                                    attention_type=attention_type, dropout=0.0, norm=True,
                                    generator=torch.Generator().manual_seed(SEED))
            layer = layer.train().to(device)
            xs = [torch.from_numpy(a).to(device).requires_grad_() for a in arrays[:3]]
            before = launches()
            out, _ = layer(*xs, torch.from_numpy(pos).to(device))
            out.backward(torch.from_numpy(arrays[3]).to(device))
            if launches() != before:
                raise AssertionError(f"wide {attention_type}: a kernel launched")
            results.append([out.detach().cpu()] + [x.grad.cpu() for x in xs]
                           + [p.grad.cpu() for p in layer.parameters()])
        worst = max(max_err(g, w)[0] / max_err(g, w)[1] for g, w in zip(*results))
        print(f"wide {attention_type} (B,n,d_k,p)=({b},{n},{d_model},{pos_dim}), train mode: "
              f"card vs CPU, output and {len(results[0]) - 1} gradients, max err/max|ref| "
              f"{worst:.3e} (tol {TOL_GALERKIN:.0e}); 0 kernel launches")
        if not worst <= TOL_GALERKIN:
            raise AssertionError(f"wide {attention_type}: card and CPU disagree")


def load_port(root: str, alias: str):
    """The port package of another checkout at `root`, imported as `alias`
    (its modules import each other relatively): its wrappers build that
    checkout's sources into `root`/build and keep their own launch counts."""
    init = os.path.join(os.path.abspath(root), "galerkin_transformer_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        alias, init, submodule_search_locations=[os.path.dirname(init)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return module


# the kernels `--against` times, each at its (shape, eps) pairs
AB_SHAPES = {"galerkin_scores_bwd": ((EX1_SHAPE, 1e-5), (EX2_TRAIN_SHAPE, 1e-7)),
             "galerkin_scores_bwd_bf16": ((EX1_SHAPE, 1e-5), (EX2_TRAIN_SHAPE, 1e-7)),
             "galerkin_scores_bf16": ((EX1_SHAPE, 1e-5), (EX2_SHAPE, 1e-7),
                                      (EX2_TRAIN_SHAPE, 1e-7)),
             "galerkin_scores": ((EX1_SHAPE, 1e-5), (EX2_SHAPE, 1e-7), (EX2_TRAIN_SHAPE, 1e-7)),
             # (BH, n, d): the forward at ex1 serving, the three backward
             # sweeps at ex1 training
             "fourier_chain": ((BATCH, RESOLUTIONS[0], 97), (BATCH, TRAIN_N, 97)),
             # the bfloat16 forward at ex1 serving and at ex1 training
             "fourier_chain_bf16": ((BATCH, RESOLUTIONS[0], 97), (BATCH, TRAIN_N, 97)),
             # the three sweeps of the bfloat16 backward at ex1 training
             "fourier_chain_mixed": ((BATCH, TRAIN_N, 97),)}
CHAINS = ("fourier_chain", "fourier_chain_bf16", "fourier_chain_mixed")
ERROR_DRAWS = 8   # more input draws on which `--against` ranks the chains' errors


def against_phase(roots, names=tuple(AB_SHAPES)) -> dict:
    """The redesigned kernels `names` of this checkout against the same
    wrappers of other checkouts of the port (``--against``), at the shapes
    of `AB_SHAPES`: the galerkin backward kernels as the training path calls
    them (no dpos; float32 inputs for ``galerkin_scores_bwd``, bfloat16 ones
    for ``galerkin_scores_bwd_bf16``), the bfloat16 forward through
    ``galerkin_scores``, ``fourier_chain`` in float32 (`chain_against`).
    Each build is held against this checkout's plain version (TOL_GALERKIN,
    TOL_BF16_BWD, TOL_BF16_KERNEL) and must be bit-equal on a second call;
    the builds are timed in turns, this one first and last (A, B, ..., B, A)."""
    packages = {"this": "galerkin_transformer_torch"}
    for i, root in enumerate(roots):
        packages[root] = load_port(root, f"other_port_{i}").__name__
    modules = lambda sub: {tag: importlib.import_module(f"{pkg}.ops.cuda.{sub}")
                           for tag, pkg in packages.items()}
    ports, fports = modules("galerkin"), modules("fourier")
    builders = list(modules("_build").values())
    t0 = time.perf_counter()
    # a forward's path phase runs this checkout's backward of its type too
    paths = [n_ for n_ in ("galerkin_scores", "galerkin_scores_bf16")
             if n_ in names and len(ports) > 1]
    extra = [n_.replace("scores", "scores_bwd") for n_ in paths]
    chain_path = "fourier_chain" in names and len(ports) > 1
    bf16_chain_path = bool({"fourier_chain_bf16", "fourier_chain_mixed"} & set(names)
                           ) and len(ports) > 1
    with ThreadPoolExecutor(len(builders)) as pool:
        logs = list(pool.map(lambda b: b.build(sorted(set(names) | set(extra if b is _build
                                                                        else []))),
                             builders))
    print(f"built {list(names)} of {list(ports)} in {time.perf_counter() - t0:.1f} s")
    for tag, log in zip(ports, logs):
        for name in names:
            for line in ptxas_summary(log.get(name, "")):
                print(f"  {tag} {name}: {line}")
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    rows = []
    for name in names:
        if name in CHAINS:
            rows += chain_against(name, fports, rng, dev)
            continue
        bf16 = name.endswith("_bf16")
        backward = "_bwd" in name
        tol = TOL_BF16_BWD if backward and bf16 else TOL_BF16_KERNEL if bf16 else TOL_GALERKIN
        for shape, eps in AB_SHAPES[name]:
            b, h, n, d_k, p = shape
            k, v, pos, params = galerkin_inputs(rng, dev, shape,
                                                torch.bfloat16 if bf16 else None)
            if backward:
                ds = _tensor(rng.standard_normal((b, h, d_k + p, d_k + p)), dev)
                args = (k, v, pos, *params, ds, eps)
                # the bfloat16 kernel writes its outputs rounded once to bfloat16
                ref = [r.bfloat16().float() if bf16 else r
                       for r in GS.galerkin_scores_bwd_reference(*args)]
                call = lambda port, args=args: port.galerkin_scores_bwd(*args, need_dpos=False)
            else:
                args = (k, v, pos, *params, eps)
                ref = [GS.galerkin_scores_reference(*args)]
                call = lambda port, args=args: (port.galerkin_scores(*args),)
            calls, errs, errs64 = {}, {}, {}
            for tag, port in ports.items():
                calls[tag] = lambda port=port, call=call: call(port)
                got, again = calls[tag](), calls[tag]()
                torch.cuda.synchronize()
                errs[tag] = max(err / scale for err, scale in
                                (max_err(g.float(), r) for g, r in zip(got, ref)
                                 if g is not None))
                if not errs[tag] <= tol:
                    raise AssertionError(f"{tag}: {name} disagrees with the plain version, "
                                         f"{errs[tag]:.3e} of max|ref|")
                if not all(g is None or torch.equal(g, a) for g, a in zip(got, again)):
                    raise AssertionError(f"{tag}: {name} is not bit-equal run to run")
                if name == "galerkin_scores":
                    errs64[tag] = scores_float64_err(got[0], args)
            if errs64 and not errs64["this"] <= TOL_GALERKIN_F64:
                raise AssertionError(f"{name} is {errs64['this']:.3e} of max|ref| from float64")
            times = {tag: [] for tag in ports}
            for tag in list(ports) + list(ports)[::-1]:
                times[tag].append(time_ms(calls[tag], 50))
            rows.append(dict(name=name, shape=list(shape), eps=eps, ms=times, rel_err=errs,
                             rel_err_f64=errs64))
            print(f"{name} (B,H,n,d_k,p)={tuple(shape)} eps={eps:.0e}: "
                  + "; ".join(f"{tag} {min(t):.4f} ms {t} (err {errs[tag]:.2e}"
                              + (f", vs float64 {errs64[tag]:.2e}" if errs64 else "") + ")"
                              for tag, t in times.items()))
    return {"against": rows,
            **{f"path {n_}": forward_path_phase(ports, torch.bfloat16 if n_.endswith("_bf16")
                                                else None) for n_ in paths},
            **({"chain_path": chain_path_phase(fports)} if chain_path else {}),
            **({"bf16_chain_path": chain_path_phase(fports, torch.bfloat16)}
               if bf16_chain_path else {})}


def chain_ops(name, rng, dev, bh, n, d):
    """What one A/B call of chain `name` does at (bh, n, d), and its operand
    triples: the forward (one triple), or the three sweeps of the backward
    (float32 q, k, v, g for ``fourier_chain``; bfloat16 q, k, v and a
    float32 g for ``fourier_chain_mixed``)."""
    def t(dtype=None):
        return _tensor(rng.standard_normal((bh, n, d)), dev, dtype)
    if name == "fourier_chain_mixed" or (name == "fourier_chain" and n != RESOLUTIONS[0]):
        dtype = torch.bfloat16 if name == "fourier_chain_mixed" else None
        q, k, v = (t(dtype) for _ in range(3))
        g = t()
        return "backward, three sweeps", [(g, v, k), (v, g, q), (k, q, g)]
    dtype = torch.bfloat16 if name == "fourier_chain_bf16" else None
    return "forward", [tuple(t(dtype) for _ in range(3))]


def chain_tolerance(name, ops) -> float:
    """Of max|ref|, a chain against its plain version: float32 sums in
    another order (TOL_FOURIER, and TOL_MIXED_F32 for a mixed sweep with a
    float32 C), or a bfloat16 score tile that may round the other way."""
    if name == "fourier_chain":
        return TOL_FOURIER
    return TOL_MIXED_F32 if ops[2].dtype == torch.float32 else TOL_BF16_KERNEL


def chain_against(name, fports, rng, dev) -> list:
    """Chain `name` (one of CHAINS) of each checkout in `fports` at the
    shapes of `AB_SHAPES` (`chain_ops`): each call held against this
    checkout's plain version (`chain_tolerance`) and bit-equal on a second
    call, each build's errors printed (for the float32 chain also against
    float64, this checkout's held to TOL_FOURIER_F64), timed in turns beside
    the library call (two matmuls; in float32 for the mixed sweeps); a
    backward is timed whole and sweep by sweep."""
    rows = []
    for bh, n, d in AB_SHAPES[name]:
        what, ops = chain_ops(name, rng, dev, bh, n, d)
        plains = [FC.fourier_chain_reference(*o) for o in ops]
        tols = [chain_tolerance(name, o) for o in ops]
        refs = [chain_float64(*o) for o in ops] if name == "fourier_chain" else None
        calls, errs, errs64 = {}, {}, {}
        for tag, port in fports.items():
            fn = getattr(port, name)
            calls[tag] = lambda fn=fn: [fn(*o) for o in ops]
            got, again = calls[tag](), calls[tag]()
            torch.cuda.synchronize()
            errs[tag] = [max_err(x, p)[0] / max_err(x, p)[1] for x, p in zip(got, plains)]
            if refs is not None:
                errs64[tag] = max(((x.double() - r).abs().max() / r.abs().max()).item()
                                  for x, r in zip(got, refs))
            if not all(e <= tol for e, tol in zip(errs[tag], tols)):
                raise AssertionError(f"{tag}: {name} disagrees with the plain version, "
                                     f"{errs[tag]} of max|ref| (tol {tols})")
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                raise AssertionError(f"{tag}: {name} is not bit-equal run to run")
        if refs is not None and not errs64["this"] <= TOL_FOURIER_F64:
            raise AssertionError(f"{name} is {errs64['this']:.3e} of max|ref| from float64")
        iters = 5 if n == RESOLUTIONS[0] else 20
        times = {tag: [] for tag in fports}
        each = {tag: [] for tag in fports}
        for tag in list(fports) + list(fports)[::-1]:
            times[tag].append(time_ms(calls[tag], iters))
            if len(ops) > 1:
                fn = getattr(fports[tag], name)
                each[tag].append([time_ms(lambda o=o: fn(*o), iters) for o in ops])
        lib_ops = [[x.float() for x in o] for o in ops] if name == "fourier_chain_mixed" else ops
        library_ms = time_ms(lambda: [torch.matmul(torch.matmul(a, b.transpose(1, 2)), c)
                                      for a, b, c in lib_ops], iters)
        draws = error_draws(name, fports, rng, dev, (bh, n, d)) if n == TRAIN_N else None
        rows.append(dict(name=name, work=what, shape=[bh, n, d], ms=times, sweeps_ms=each,
                         rel_err=errs, rel_err_f64=errs64, library_ms=library_ms,
                         rel_err_draws=draws))
        print(f"{name} {what} (BH,n,d)=({bh},{n},{d}): " + "; ".join(
            f"{tag} {min(t):.4f} ms {t}"
            + (f" (sweeps {[round(min(x), 4) for x in zip(*each[tag])]})" if each[tag] else "")
            + f" (err {', '.join(f'{e:.4e}' for e in errs[tag])}"
            + (f", vs float64 {errs64[tag]:.2e}" if refs is not None else "") + ")"
            for tag, t in times.items()) + f"; library {library_ms:.4f} ms")
    return rows


def error_draws(name, fports, rng, dev, shape, draws: int = ERROR_DRAWS) -> dict:
    """Chain `name` of each checkout against this checkout's plain version
    on `draws` more input draws at `shape` (a bfloat16 score tile that
    lands near a rounding boundary may round either way, so one draw does
    not rank two builds): per checkout, per call of `chain_ops`, the error
    of max|ref| in each draw; printed with the draws in which this
    checkout's error is above each other's."""
    out = {tag: [] for tag in fports}
    for _ in range(draws):
        _, ops = chain_ops(name, rng, dev, *shape)
        plains = [FC.fourier_chain_reference(*o) for o in ops]
        for tag, port in fports.items():
            got = [getattr(port, name)(*o) for o in ops]
            out[tag].append([max_err(x, p)[0] / max_err(x, p)[1] for x, p in zip(got, plains)])
    for tag, errs in out.items():
        per_call = [[e[i] for e in errs] for i in range(len(errs[0]))]
        above = {other: [sum(a[i] > b[i] for a, b in zip(errs, out[other]))
                         for i in range(len(per_call))]
                 for other in fports if other != "this"} if tag == "this" else {}
        print(f"  {name} {tuple(shape)}, {draws} draws, {tag}: errors of max|ref| "
              + "; ".join(f"[{', '.join(f'{e:.3e}' for e in es)}] mean {sum(es) / draws:.4e}"
                          for es in per_call)
              + "".join(f"; above {other} in {k} of {draws}" for other, k in above.items()))
    return out


def profile_swapped(module, impls: dict, works: dict, kernels: dict, repeats: int) -> dict:
    """`works` profiled with the attributes of `module` set to each of
    `impls` in turn (`impls[tag]`: attribute name -> function), in the order
    A, B, ..., B, A, the attributes restored after: per work and tag, the
    device time of one call (torch.profiler, the mean of `repeats` after two
    warm-up calls), and the part of it, and the launches, of the device
    kernels named in `kernels[tag]`."""
    cuda = torch.autograd.DeviceType.CUDA
    rows = {work: {tag: [] for tag in impls} for work in works}
    own = {attr: getattr(module, attr) for fns in impls.values() for attr in fns}
    try:
        for tag in list(impls) + list(impls)[::-1]:
            for attr, fn in impls[tag].items():
                setattr(module, attr, fn)
            for work, fn in works.items():
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]
                                            ) as prof:
                    for _ in range(repeats):
                        fn()
                    torch.cuda.synchronize()
                busy = part = count = 0
                for e in prof.key_averages():
                    if e.device_type == cuda and e.device_time_total > 0:
                        busy += e.device_time_total
                        if e.key in kernels[tag]:
                            part += e.device_time_total
                            count += e.count
                rows[work][tag].append(dict(device_ms=busy / repeats / 1e3,
                                            kernel_ms=part / repeats / 1e3,
                                            kernel_launches=count / repeats))
    finally:
        for attr, fn in own.items():
            setattr(module, attr, fn)
    return rows


def print_swapped(what: str, rows: dict):
    for work, by_tag in rows.items():
        print(f"{work}, {what} of each checkout: " + "; ".join(
            f"{tag} device " + ", ".join(f"{r['device_ms']:.3f}" for r in runs)
            + " ms, kernel " + ", ".join(f"{r['kernel_ms']:.4f}" for r in runs)
            + " ms in " + ", ".join(f"{r['kernel_launches']:g}" for r in runs) + " kernels"
            for tag, runs in by_tag.items()))


def chain_path_phase(fports, dtype=None, repeats: int = 5) -> list:
    """One ex1 fourier request at n = 8192 (batch 8) and one ex1 fourier
    train step at n = 2048, in float32 with the ``fourier_chain`` of each
    checkout of `fports` in turn, or with the bfloat16 encoder (`dtype`)
    with each checkout's ``fourier_chain_bf16`` and ``fourier_chain_mixed``
    (`profile_swapped`; ``FourierAttention`` takes them from this
    checkout's module)."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    names = ("fourier_chain",) if dtype is None else CHAINS[1:]
    # the device kernels of each checkout's chains at the path's sizes: its
    # prologue and chain (a padded copy runs generic kernels, counted only in
    # the device time)
    kernels = {tag: set() for tag in fports}
    for name in names:
        for bh, n, d in AB_SHAPES[name]:
            _, ops = chain_ops(name, rng, dev, bh, n, d)
            for tag, port in fports.items():
                fn = getattr(port, name)
                kernels[tag] |= {k for k in device_kernels(lambda fn=fn: [fn(*o) for o in ops])
                                 if "chain" in k or "split_kernel" in k or "layout_kernel" in k}
    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = "fourier"
    gpu = Predictor(SimpleTransformer.from_config(cfg, device="cuda", seed=SEED, dtype=dtype))
    batch = make_batch(rng, RESOLUTIONS[0])
    train = BurgersDataset(subsample=SUBSAMPLE, train_data=True, train_portion=0.5,
                           n_samples_synthetic=TRAIN_SAMPLES)
    batches = list(DataLoader(train, BATCH, shuffle=True, drop_last=True, seed=SEED))
    model = SimpleTransformer.from_config(cfg, device="cuda", seed=SEED, dtype=dtype)
    h = 1 / TRAIN_N
    step = make_burgers_steps(model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1),
                              WeightedL2Loss(h=h),
                              AdamOneCycle(model.parameters(), 1e-3, 100 * len(batches)))[0]
    kind = dtype_name(dtype)
    works = {f"ex1 fourier {kind} request n={RESOLUTIONS[0]} batch={BATCH}": lambda: gpu(batch),
             f"ex1 fourier {kind} train step n={TRAIN_N} batch={BATCH}": lambda: step(batches[0])}
    impls = {tag: {name: getattr(port, name) for name in names}
             for tag, port in fports.items()}
    rows = profile_swapped(FC, impls, works, kernels, repeats)
    print_swapped(" and ".join(names), rows)
    return [dict(work=work, runs=by_tag) for work, by_tag in rows.items()]


def forward_path_phase(ports, dtype=torch.bfloat16, repeats: int = 5) -> list:
    """The ex2 requests at both grids and the ex2 train step, with the
    bfloat16 encoder (`dtype`) or in float32 (None), with the galerkin
    forward of each checkout of `ports` in turn (this checkout's
    ``_scores_forward`` replaced by theirs; all else is this checkout's),
    profiled by `profile_swapped`: the device time of one request or step,
    and the part of it, and the launches, of the device kernels that one
    call of that checkout's forward runs."""
    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda")
    kind = dtype_name(dtype)
    k, v, pos, params = galerkin_inputs(rng, dev, EX2_TRAIN_SHAPE, dtype)
    forward_kernels = {tag: set(device_kernels(
        lambda port=port: port.galerkin_scores(k, v, pos, *params, 1e-7)))
        for tag, port in ports.items()}
    works = {}
    for n_f, n_c in GRIDS_2D:
        gpu = Predictor(FourierTransformer2D.from_config(ex2_config(n_f, n_c), seed=SEED,
                                                         dtype=dtype))
        grid_pos, grid = darcy_grids(n_f, n_c)
        batch = dict(node=rng.standard_normal((BATCH_2D, n_f, n_f, 1)).astype(np.float32),
                     pos=grid_pos[None].repeat(BATCH_2D, 0), grid=grid[None].repeat(BATCH_2D, 0))
        works[f"ex2 {kind} request ({n_f},{n_c})"] = lambda gpu=gpu, batch=batch: gpu(batch)
    batches, normalizer, (n_f, n_c) = ex2_train_data()
    _, step = ex2_step("cuda", dtype, ex2_config(n_f, n_c), batches, normalizer, n_f)
    works[f"ex2 {kind} train step ({n_f},{n_c})"] = lambda: step(batches[0])

    forwards = {tag: {"_scores_forward": port._scores_forward} for tag, port in ports.items()}
    rows = profile_swapped(GS, forwards, works, forward_kernels, repeats)
    print_swapped(f"the {kind} forward", rows)
    return [dict(work=work, runs=by_tag) for work, by_tag in rows.items()]


def bound(nbytes: int, flops: int, peak: dict, rate: str = "f32_flops") -> dict:
    """The least time the card could take: bytes over its memory rate or
    operations over its peak `rate`, whichever is larger."""
    t_bytes = nbytes / peak["bytes"] * 1e3
    t_ops = flops / peak[rate] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def make_batch(rng, n):
    pos = np.linspace(0, 1, n, dtype=np.float32)[None, :, None].repeat(BATCH, 0)
    node = rng.standard_normal((BATCH, n, 1)).astype(np.float32)
    return dict(node=node, pos=pos, grid=pos)


def device_ms(work) -> float:
    """Device time of one `work()` call: queued behind a device-side spin, so
    that the host's launch cost is hidden, between two CUDA events."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    work()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def profile(work, top: int = 5) -> dict:
    """One `work()` call (a served request, or a train step) under
    torch.profiler: its device time (the kernels' and copies' times
    summed), its host-clock time with the final synchronize, the device's
    busy share, how many kernel records the profiler saw, and the top
    kernels by time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    top_k = ", ".join(f"{e.key[:48]} {e.device_time_total / 1e3:.3f}" for e in
                      sorted(events, key=lambda e: e.device_time_total, reverse=True)[:top])
    kernels = sum(e.count for e in events if "emcpy" not in e.key and "emset" not in e.key)
    return dict(busy_ms=busy_ms, wall_ms=wall_ms, busy=busy_ms / wall_ms, kernels=kernels,
                top=top_k)


def breakdown(work, top: int = 5) -> str:
    """Device time of one `work()` call by kernel (torch.profiler), and the
    device's busy share of its host-clock time, the final synchronize
    included."""
    p = profile(work, top)
    return (f"device busy {p['busy_ms']:.3f} ms of {p['wall_ms']:.3f} ms profiled "
            f"({100 * p['busy']:.1f} %); top kernels (ms): {p['top']}")


# each wrapper counts its kernel's launches on itself
COUNTERS = {"galerkin_scores": GS.galerkin_scores,
            "galerkin_scores_bwd": GS.galerkin_scores_bwd,
            "galerkin_scores_bf16": GS.galerkin_scores_bf16,
            "galerkin_scores_bwd_bf16": GS.galerkin_scores_bwd_bf16,
            "fourier_chain": FC.fourier_chain,
            "fourier_chain_bf16": FC.fourier_chain_bf16,
            "fourier_chain_mixed": FC.fourier_chain_mixed}


def launches():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def reset_launches():
    for fn in COUNTERS.values():
        fn.launches = 0


def eager_request(model, normalizer, batch) -> np.ndarray:
    """The serving path without a graph: the model called directly under
    inference_mode, numpy in, numpy out (what `Predictor` ran before it
    captured one graph per request shape)."""
    dev = next(model.parameters()).device
    kwargs = ({"normalizer": normalizer}
              if "normalizer" in inspect.signature(model.forward).parameters else {})
    graph = any(isinstance(m, (GCN, GAT)) for m in model.modules())   # as Predictor does
    with torch.inference_mode():
        node, pos, grid = (torch.as_tensor(batch[k], device=dev).float()
                           for k in ("node", "pos", "grid"))
        edge = torch.as_tensor(batch["edge"], device=dev).float() if graph else None
        return model(node, edge, pos, grid, **kwargs)["preds"].cpu().numpy()


def timed_requests(serve, batches) -> tuple:
    """Each batch served once, host clock (numpy in, numpy out: each call
    ends synchronized): (outputs, ms per request)."""
    outs, ms = [], []
    for batch in batches:
        t0 = time.perf_counter()
        outs.append(serve(batch))
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def graph_launches(replayed) -> Counter:
    """The kernel launches of captured paths, from their (graph kernels,
    replays) pairs (served requests, train or eval steps): the wrapper
    launches among each graph's kernels times its replays, less the one
    capture, which the wrappers counted and which launched nothing."""
    out = Counter()
    for kernels, replays in replayed:
        for name, n in wrapper_launches(kernels).items():
            out[name] += n * (replays - 1)
    return out


def forward_launches(forwards) -> Counter:
    """`graph_launches` of served requests' replayed forwards."""
    return graph_launches((f.kernels(), f.replays) for f in forwards)


def runner_launches(runners) -> Counter:
    """`graph_launches` of `DeviceEpochRunner`s' captured train and eval steps."""
    return graph_launches(pair for runner in runners for pair in runner.replayed())


def serve_and_check(tag, gpu, cpu, batches, kernel, per_request, points, shape, tol,
                    replayed, check=None, scale_of=lambda ref: float(np.abs(ref).max())):
    """`gpu` (a Predictor on the card) serves `batches` of one shape: the
    first request eagerly, then the capture, then each request a replay of
    its graph.  Holds the graph's kernel nodes to exactly `per_request`
    launches of `kernel` (None: no kernel) and none of any other, and the
    wrappers' counters still over the replays; checks every output, and
    compares the first one with `cpu` on the same weights, relative to
    `scale_of` the CPU's output (its largest entry, unless the caller knows
    a part of it that the model does not compute).  Times each request
    replayed and eagerly (`eager_request`, the same batches), with the
    device time (kernels and copies, torch.profiler) and busy share of
    each, a replay's device span (CUDA events around the graph alone, the
    gaps between its kernels included), and the memory the shape holds
    (reserved before and after its first request and capture).  A second
    Predictor, captured with cuDNN's deterministic algorithms, must give
    the eager call's output bit for bit; on cuDNN's defaults the replay
    and the eager call agree to `tol`.  Appends the shape's replayed
    forwards to `replayed`.  Returns the first output."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    gpu.warmup(batches[0])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held_mib = (torch.cuda.memory_reserved() - reserved) / 2 ** 20
    forward = gpu.captured(batches[0])
    replayed.append(forward)
    want = {} if kernel is None else {kernel: per_request}
    graph = dict(wrapper_launches(forward.kernels()))
    if forward.graph is None or graph != want:
        raise AssertionError(f"{tag}: the captured request holds {graph}, expected {want}")
    before, replays = launches(), forward.replays
    outs, ms = timed_requests(gpu, batches)
    if launches() != before or forward.replays - replays != len(batches):
        raise AssertionError(f"{tag}: {forward.replays - replays} replays of "
                             f"{len(batches)} requests, counters moved")
    for out in outs:
        if out.shape != shape or not np.isfinite(out).all():
            raise AssertionError(f"{tag}: bad output {out.shape}, "
                                 f"finite={np.isfinite(out).all()}")
        if check is not None:
            check(out)
    ref = cpu(batches[0])
    err = float(np.abs(outs[0] - ref).max())
    scale = scale_of(ref)

    def eager(batch):
        return eager_request(gpu.model, gpu.normalizer, batch)

    eager(batches[0])
    eager_outs, eager_ms = timed_requests(eager, batches)
    gap = float(np.abs(outs[0] - eager_outs[0]).max())
    with deterministic_cudnn():
        det = Predictor(gpu.model, normalizer=gpu.normalizer).warmup(batches[0])
        replayed.append(det.captured(batches[0]))
        bit_equal = np.array_equal(det(batches[1]), eager(batches[1]))
    latency, eager_latency = statistics.median(ms), statistics.median(eager_ms)
    p, q = profile(lambda: gpu(batches[1])), profile(lambda: eager(batches[1]))
    span = device_ms(forward)   # a replay alone, the gaps between its kernels included
    print(f"serve {tag}: median request {latency:.3f} ms replayed over {len(batches)} (min "
          f"{min(ms):.3f}, max {max(ms):.3f}), eager {eager_latency:.3f} ms "
          f"({eager_latency / latency:.2f}x); device time {p['busy_ms']:.3f} ms replayed "
          f"(busy {100 * p['busy_ms'] / latency:.1f} % of the request), {q['busy_ms']:.3f} ms "
          f"eager (busy {100 * q['busy_ms'] / eager_latency:.1f} %); a replay's span "
          f"{span:.3f} ms ({100 * span / latency:.1f} % of the request); graph memory "
          f"{held_mib:.1f} MiB; "
          f"{points / latency * 1e3:.4e} grid-points/s; launches/request {want or 0} (graph "
          f"kernel nodes); vs CPU plain path max_abs_err={err:.3e} scale={scale:.3e} "
          f"tol={tol:.1e}; replay vs eager {gap:.3e} on cuDNN defaults, "
          f"{'bit-equal' if bit_equal else 'NOT bit-equal'} with cuDNN deterministic")
    seen = ("all" if p["kernels"] >= len(forward.kernels())
            else f"only {p['kernels']}; the graph's kernels: "
                 f"{Counter(demangled(forward.kernels())).most_common(8)}")
    print(f"  breakdown {tag} (a replay of {len(forward.kernels())} kernel nodes, the profiler "
          f"saw {seen}): top kernels (ms): {p['top']}")
    if not (err <= tol * scale and gap <= tol * scale and bit_equal):
        raise AssertionError(f"{tag}: GPU and CPU, or replay and eager call, disagree")
    return outs[0]


def same_weights(gpu, cpu):
    """`gpu` and `cpu`: two Predictors, or two models."""
    gpu, cpu = (getattr(x, "model", x).state_dict() for x in (gpu, cpu))
    for key, w in gpu.items():
        if not torch.equal(w.cpu(), cpu[key]):
            raise AssertionError(f"seeded weights differ at {key}")


def dtype_name(dtype):
    return "f32" if dtype is None else "bf16"


def serving_phase(rng):
    """The first main path: ex1, in float32 and with the bfloat16 encoder,
    and a galerkin model with heads wider than the kernels take.  Returns
    the launch counts of its whole run, the graph replays' included."""
    reset_launches()
    replayed = []
    for dtype in DTYPES:
        for attention_type in ATTENTION_TYPES:
            cfg = load_config("ex1_burgers")
            cfg["attention_type"] = attention_type
            n_layers = cfg["num_encoder_layers"]
            gpu = Predictor(SimpleTransformer.from_config(cfg, device="cuda", seed=SEED,
                                                          dtype=dtype))
            cpu = Predictor(SimpleTransformer.from_config(cfg, device="cpu", seed=SEED,
                                                          dtype=dtype), device="cpu")
            same_weights(gpu, cpu)
            for n in RESOLUTIONS:
                batches = [make_batch(rng, n) for _ in range(REQUESTS)]
                serve_and_check(
                    f"ex1 {attention_type} {dtype_name(dtype)} n={n} batch={BATCH}",
                    gpu, cpu, batches, KERNEL_OF[attention_type, dtype], n_layers,
                    BATCH * n, (BATCH, n, 1),
                    TOL_SERVE if dtype is None else TOL_SERVE_BF16, replayed)
    # heads of d_k + pos_dim = 129 columns take the XLA route: no kernel
    cfg = {**load_config("ex1_burgers"), **WIDE_EX1}
    n = RESOLUTIONS[1]
    gpu, cpu = (Predictor(SimpleTransformer.from_config(cfg, device=d, seed=SEED), device=d)
                for d in ("cuda", "cpu"))
    serve_and_check(f"ex1 galerkin f32 wide heads (d_k+p=129) n={n} batch={BATCH}", gpu, cpu,
                    [make_batch(rng, n) for _ in range(REQUESTS)], None, 0, BATCH * n,
                    (BATCH, n, 1), TOL_SERVE, replayed)
    counts = Counter(launches())
    counts.update(forward_launches(replayed))
    return {name: counts[name] for name in COUNTERS}


def serving_2d_phase(rng):
    """The third main path: the full-width ex2 Darcy FourierTransformer2D
    behind `Predictor`, with a normalizer and the Dirichlet boundary, at two
    grid pairs, in float32 and with the bfloat16 encoder and scalers.
    Returns the launch counts of its whole run, the graph replays'
    included."""
    reset_launches()
    replayed = []

    def ring_is_zero(out):
        if (out[:, 0].any() or out[:, -1].any() or out[:, :, 0].any()
                or out[:, :, -1].any() or not out[:, 1:-1, 1:-1].any()):
            raise AssertionError("the Dirichlet ring is not zero, or the interior is")

    for n_f, n_c in GRIDS_2D:
        cfg = ex2_config(n_f, n_c)
        n_layers = cfg["num_encoder_layers"]
        normalizer = ((0.1 * rng.standard_normal((n_f, n_f, 1))).astype(np.float32),
                      rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32),
                      np.float32(1e-5))

        def model_part(out):
            """The interior with the normalizer undone: what the model computes."""
            mean, std, eps = normalizer
            return ((out - mean) / (std + eps))[:, 1:-1, 1:-1]

        def variation(out):
            """How far the model's part moves over the grid and the batch.  With
            random weights a constant (the decoder's bias) is most of the output;
            the encoder shows in what is left."""
            part = model_part(out)
            return float(np.abs(part - part.mean()).max())

        def largest(out):
            return float(np.abs(model_part(out)).max())

        pos, grid = darcy_grids(n_f, n_c)
        batches = [dict(node=rng.standard_normal((BATCH_2D, n_f, n_f, 1)).astype(np.float32),
                        pos=pos[None].repeat(BATCH_2D, 0), grid=grid[None].repeat(BATCH_2D, 0))
                   for _ in range(REQUESTS)]
        first = {}
        for dtype in DTYPES:
            gpu = Predictor(FourierTransformer2D.from_config(cfg, seed=SEED, dtype=dtype),
                            normalizer=normalizer)
            cpu = Predictor(FourierTransformer2D.from_config(cfg, device="cpu", seed=SEED,
                                                             dtype=dtype),
                            normalizer=normalizer, device="cpu")
            same_weights(gpu, cpu)
            first[dtype] = serve_and_check(
                f"ex2 galerkin {dtype_name(dtype)} (n_f,n_c)=({n_f},{n_c}) "
                f"scalers={cfg['downscaler_size']},{cfg['upscaler_size']} batch={BATCH_2D}",
                gpu, cpu, batches, KERNEL_OF["galerkin", dtype], n_layers,
                BATCH_2D * n_f * n_f, (BATCH_2D, n_f, n_f, 1),
                TOL_SERVE if dtype is None else TOL_SERVE_BF16, replayed, check=ring_is_zero,
                scale_of=variation if dtype is None else largest)
        far = float(np.abs(first[torch.bfloat16] - first[None]).max())
        print(f"  ex2 (n_f,n_c)=({n_f},{n_c}): bf16 output is {far:.3e} from the f32 output, "
              f"whose model part is at most {largest(first[None]):.3e} and varies by "
              f"{variation(first[None]):.3e}")
    counts = Counter(launches())
    counts.update(forward_launches(replayed))
    return {name: counts[name] for name in COUNTERS}


def serving_ex4_phase(rng):
    """The fifth main path, served: one rollout step of the full-width ex4
    FourierTransformer2DLite (862,049 parameters, batch 4 of a 10-step window
    on the 64² grid, float32) behind `Predictor`, against the CPU plain path.
    No kernel of the port runs on this path (the attention takes the block
    form without per-head LN).  Returns the launch counts of its run."""
    reset_launches()
    replayed = []
    cfg = load_config("ex4_navier_stokes")
    gpu = Predictor(FourierTransformer2DLite.from_config(cfg, seed=SEED))
    cpu = Predictor(FourierTransformer2DLite.from_config(cfg, device="cpu", seed=SEED),
                    device="cpu")
    same_weights(gpu, cpu)
    n_params = sum(p.numel() for p in gpu.model.parameters())
    if n_params != EX4_PARAMS:
        raise AssertionError(f"ex4: {n_params} parameters, expected {EX4_PARAMS}")
    pos, grid = ns_grids(EX4_GRID)
    batches = [dict(node=rng.standard_normal((BATCH_2D, EX4_GRID, EX4_GRID, EX4_WINDOW))
                    .astype(np.float32), pos=pos[None].repeat(BATCH_2D, 0),
                    grid=grid[None].repeat(BATCH_2D, 0)) for _ in range(REQUESTS)]
    serve_and_check(f"ex4 galerkin f32 n={EX4_GRID}^2 window={EX4_WINDOW} batch={BATCH_2D} "
                    f"({n_params} parameters)", gpu, cpu, batches, None, 0,
                    BATCH_2D * EX4_GRID ** 2, (BATCH_2D, EX4_GRID, EX4_GRID, 1), TOL_SERVE,
                    replayed)
    counts = Counter(launches())
    counts.update(forward_launches(replayed))
    return {name: counts[name] for name in COUNTERS}


def compare_step(tag, steps, models, batch, per_step, tol_loss, tol_grad, floor=0.0):
    """One train step on the card and one on the CPU from the same weights
    and batch: the launch counts of the card's step are exactly `per_step`
    (and 0 for every other kernel), the losses agree to `tol_loss`
    (relative) and every gradient to `tol_grad` of its largest entry, or of
    `floor` times the model's largest gradient where that is more."""
    before = launches()
    got = [float(x) for x in steps["cuda"](batch)]
    after = launches()
    want = [float(x) for x in steps["cpu"](batch)]
    for name in after:
        n_want = per_step.get(name, 0)
        if after[name] - before[name] != n_want:
            raise AssertionError(f"train {tag}: {name} launched "
                                 f"{after[name] - before[name]} times in one step, "
                                 f"expected {n_want}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want) if b != 0)
    if not (all(math.isfinite(x) for x in got) and loss_err <= tol_loss):
        raise AssertionError(f"train {tag}: losses {got} vs CPU {want}")
    grad_err, worst = hold_grads(
        f"train {tag}", {k: p.grad for k, p in models["cuda"].named_parameters()},
        {k: p.grad for k, p in models["cpu"].named_parameters()}, tol_grad, floor)
    print(f"train {tag}: losses {got} vs CPU {want} (max rel err {loss_err:.3e}, tol "
          f"{tol_loss:.1e}); gradients max err/max|g| {grad_err:.3e} at {worst} (tol "
          f"{tol_grad:.1e}); launches/step {per_step}")


def hold_grads(tag, got, want, tol, floor=0.0):
    """Every gradient of `got` (the card's, by name) within `tol` of the
    largest entry of the same gradient in `want` (the CPU's), or of `floor`
    times the largest entry of all of `want` where that is more.  Returns
    the worst ratio and its name."""
    g_floor = floor * max(float(g.abs().max()) for g in want.values())
    grad_err, worst = 0.0, ""
    for key, ref in want.items():
        err, scale = max_err(got[key].cpu(), ref)
        scale = max(scale, g_floor)
        rel = err / scale if scale > 0 else err
        if rel > grad_err:
            grad_err, worst = rel, key
        if not err <= tol * scale:
            raise AssertionError(f"{tag}: gradient of {key} "
                                 f"max_abs_err={err:.3e} max|ref|={scale:.3e}")
    return grad_err, worst


def time_steps(tag, step, batches, n_steps, points):
    for b in batches[:2]:   # warm-up
        step(b)
    torch.cuda.synchronize()
    ms = []
    for i in range(n_steps):
        t0 = time.perf_counter()
        step(batches[i % len(batches)])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(ms)
    print(f"train {tag}: median step {step_ms:.2f} ms over {n_steps} (min {min(ms):.2f}, "
          f"max {max(ms):.2f}), {points / step_ms * 1e3:.4e} grid-points/s")
    print(f"  breakdown train {tag}: {breakdown(lambda: step(batches[0]))}")


def ex1_train_data():
    """The ex1 training set of the training phases (synthetic Cole–Hopf)."""
    return BurgersDataset(subsample=SUBSAMPLE, train_data=True, train_portion=0.5,
                          n_samples_synthetic=TRAIN_SAMPLES)


def no_dropout(model):
    """Every dropout rate of `model` set to 0: the ex1 config's rates are 0,
    but the linear and softmax layers force 0.1 (encoder.py:56-58), and the
    two devices draw different masks."""
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
        elif isinstance(m, SimpleAttention):
            m.score_rate = 0.0
        elif isinstance(m, MultiHeadDotProductAttention):
            m.dropout = 0.0
    return model


def ex1_step(device, dtype, attention_type, latents=False):
    """A full-width ex1 SimpleTransformer (dropout off), its optimizer and
    its steps; with `latents` the model returns its latents and the loss
    adds the orthogonality penalty on them."""
    cfg = load_config("ex1_burgers")
    cfg.update(attention_type=attention_type, return_latent=latents)
    model = no_dropout(SimpleTransformer.from_config(cfg, device=device, seed=SEED,
                                                     dtype=dtype))
    # 100 epochs of the training set's batches
    opt = AdamOneCycle(model.parameters(), 1e-3, 100 * (TRAIN_SAMPLES // 2 // BATCH))
    h = 1 / TRAIN_N
    loss = WeightedL2Loss(regularizer=True, h=h, gamma=0.1, orthogonal_reg=latents)
    return (model, opt) + make_burgers_steps(model, loss, WeightedL2Loss(h=h), opt)


def training_phase():
    """The second main path: the ex1 train step, in float32 and with the
    bfloat16 encoder.  Returns the launch counts of its whole run."""
    reset_launches()
    train = ex1_train_data()
    batches = list(DataLoader(train, BATCH, shuffle=True, drop_last=True, seed=SEED))
    for dtype in DTYPES:
        for attention_type in ATTENTION_TYPES:
            steps, models = {}, {}
            for device in ("cuda", "cpu"):
                models[device], _, steps[device], _ = ex1_step(device, dtype, attention_type)
            tag = f"ex1 {attention_type} {dtype_name(dtype)} n={TRAIN_N} batch={BATCH}"
            compare_step(tag, steps, models, batches[0],
                         LAUNCHES_PER_STEP[attention_type, dtype],
                         TOL_TRAIN_LOSS if dtype is None else TOL_TRAIN_LOSS_BF16,
                         TOL_TRAIN_GRAD if dtype is None else TOL_TRAIN_GRAD_BF16)
            time_steps(tag, steps["cuda"], batches[1:], TRAIN_STEPS, BATCH * TRAIN_N)
    return launches()


def ex2_config(n_f, n_c):
    """The ex2 config with the scalers of (n_f, n_c) and the ex2 example's
    rule for the galerkin LayerNorm's eps."""
    cfg = load_config("ex2_darcy")
    cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
    cfg["norm_eps"] = 1e-7 if n_f < 211 else 1e-5
    return cfg


def ex2_train_data():
    """`DarcyDataset` at TRAIN_2D, batches of BATCH_2D from it, the target
    normalizer and (n_f, n_c)."""
    t0 = time.perf_counter()
    train = DarcyDataset(train_data=True, **TRAIN_2D)
    n_f = (TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_nodes"] + 1
    n_c = (TRAIN_2D["n_grid_fine"] - 1) // TRAIN_2D["subsample_attn"] + 1
    print(f"DarcyDataset: {len(train)} training samples at (n_f, n_c) = ({n_f}, {n_c}) "
          f"in {time.perf_counter() - t0:.1f} s")
    batches = list(DataLoader(train, BATCH_2D, shuffle=True, drop_last=True, seed=SEED))
    return train, batches, train.normalizer_y.as_tuple(), (n_f, n_c)


def ex2_step(device, dtype, config, batches, normalizer, n_f, steps=False):
    """A full-width ex2 FourierTransformer2D and its `make_darcy_steps` train
    step; with `steps`, (model, optimizer, train step, eval step)."""
    model = FourierTransformer2D.from_config(config, device=device, seed=SEED, dtype=dtype)
    opt = AdamOneCycle(model.parameters(), 1e-3, 100 * len(batches), pct_start=0.3,
                       grad_clip=0.99)
    h = 1 / n_f
    train_step, eval_step = make_darcy_steps(
        model, WeightedL2Loss2d(regularizer=True, h=h, gamma=0.5), WeightedL2Loss2d(h=h),
        opt, normalizer=normalizer)
    return (model, opt, train_step, eval_step) if steps else (model, train_step)


def training_2d_phase():
    """The fourth main path: the train step of the full-width ex2 Darcy
    FourierTransformer2D on batches from `DarcyDataset`, in float32 and with
    the bfloat16 encoder and scalers.  Returns the launch counts of its run."""
    reset_launches()
    _, batches, normalizer, (n_f, n_c) = ex2_train_data()
    cfg = ex2_config(n_f, n_c)
    n_layers = cfg["num_encoder_layers"]

    def make_step(device, dtype, config):
        return ex2_step(device, dtype, config, batches, normalizer, n_f)

    grads = {}   # (dtype, device) -> the gradients of the compared step
    for dtype in DTYPES:
        steps, models = {}, {}
        for device in ("cuda", "cpu"):   # dropout off: two devices draw other masks
            models[device], steps[device] = make_step(device, dtype, {**cfg, **NO_DROPOUT})
        same_weights(models["cuda"], models["cpu"])
        fwd, bwd = (("galerkin_scores", "galerkin_scores_bwd") if dtype is None else
                    ("galerkin_scores_bf16", "galerkin_scores_bwd_bf16"))
        tag = (f"ex2 galerkin {dtype_name(dtype)} (n_f,n_c)=({n_f},{n_c}) "
               f"batch={BATCH_2D}")
        compare_step(tag, steps, models, batches[0], {fwd: n_layers, bwd: n_layers},
                     TOL_TRAIN_LOSS if dtype is None else TOL_TRAIN_LOSS_BF16,
                     TOL_TRAIN_GRAD if dtype is None else TOL_TRAIN_GRAD_BF16)
        for device, model in models.items():
            grads[dtype, device] = {k: p.grad.cpu() for k, p in model.named_parameters()}
        del steps, models
        _, step = make_step("cuda", dtype, cfg)   # the config's dropout rates
        time_steps(tag + " config dropout", step, batches, TRAIN_2D_STEPS,
                   BATCH_2D * n_f * n_f)
    counts = launches()

    # how far bf16 moves each gradient from f32, on the card and on the CPU: a
    # card farther from f32 than the CPU would point at a card kernel
    def largest_gap(label, got, ref):
        gaps = {k: max_err(g, ref[k]) for k, g in got.items()}
        key = max(gaps, key=lambda k: gaps[k][0] / gaps[k][1])
        print(f"ex2 step, {label}: largest gap {gaps[key][0] / gaps[key][1]:.3e} of "
              f"max|g_ref| at {key}")

    for device in ("cuda", "cpu"):
        largest_gap(f"bf16 vs f32 (ref) gradients on the {device}",
                    grads[torch.bfloat16, device], grads[None, device])
    # diagnostic, outside the main path's counts: the card's bf16 step once
    # more with galerkin_scores_bwd_bf16 replaced by its plain version on the
    # same CUDA inputs (outputs in the kernel's types), then with the forward
    # kernel replaced too: what is left of the gap then comes from no galerkin
    # kernel
    def plain_bwd_bf16(k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, eps=1e-5,
                       need_dpos=True):
        dk, dv, dpos, *dparams = GS._scores_bwd_bf16_reference(
            k, v, pos, scale_k, bias_k, scale_v, bias_v, ds, eps)
        return (dk.bfloat16(), dv.bfloat16(), dpos if need_dpos else None,
                *(d.float() for d in dparams))

    # (the function replaced, its plain version, the counter of its kernel)
    swaps = {"galerkin_scores_bwd_bf16": (GS.galerkin_scores_bwd_bf16, plain_bwd_bf16,
                                          "galerkin_scores_bwd_bf16"),
             "_scores_forward": (GS._scores_forward, GS.galerkin_scores_reference,
                                 "galerkin_scores_bf16")}
    for swapped in (["galerkin_scores_bwd_bf16"], list(swaps)):
        model, step = make_step("cuda", torch.bfloat16, {**cfg, **NO_DROPOUT})
        try:
            for name in swapped:
                setattr(GS, name, swaps[name][1])
            before = launches()
            step(batches[0])
            after = launches()
            if any(after[swaps[name][2]] != before[swaps[name][2]] for name in swapped):
                raise AssertionError(f"diagnostic: a replaced kernel launched ({swapped})")
        finally:
            for name, (fn, _, _) in swaps.items():
                setattr(GS, name, fn)
        got = {k: p.grad.cpu() for k, p in model.named_parameters()}
        what = ("the plain galerkin backward in place of its kernel" if len(swapped) == 1
                else "the plain galerkin forward and backward in place of their kernels")
        largest_gap(f"diagnostic, bf16 with {what} vs f32 (ref) gradients on the cuda", got,
                    grads[None, "cuda"])
        largest_gap(f"diagnostic, bf16 with {what} vs bf16 with the kernels (ref) on the "
                    f"cuda", got, grads[torch.bfloat16, "cuda"])
    return counts


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the block: the 2D model's
    convolutions may otherwise take algorithms whose sums run in an order
    that differs run to run, so that no two runs, eager or replayed, agree
    bit for bit."""
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def run_loop(runner, epochs):
    """`epochs` epochs of `runner`: (per-step losses, (steps, n_losses);
    the step time inside the loop of each epoch, its wall over its steps,
    synchronized; the validation time of each epoch)."""
    losses, loop_ms, val_ms = [], [], []
    for e in range(epochs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch_losses = runner.train_epoch(e)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        val = float(runner.validate())
        loop_ms.append((t1 - t0) * 1e3 / runner.n_batches)
        val_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(epoch_losses.cpu().numpy().copy())
        if not math.isfinite(val):
            raise AssertionError(f"validation metric {val}")
    return np.concatenate(losses), loop_ms, val_ms


def loop_case(tag, make, train, batch, per_step, epochs, tol_loss, tol_param, points):
    """`make(device)` -> (model, optimizer, train step, eval step).  Over
    `train` in batches of `batch` (shuffle and dropout off), with cuDNN's
    deterministic algorithms: `epochs` epochs of `DeviceEpochRunner` on the
    card and as many eager host-loop steps from the same weights, whose
    per-step losses and final weights must agree (bit-equal expected; else
    to `tol_loss` relative and `tol_param` of each weight's largest entry).
    Then, with cuDNN's defaults (as the drivers run), a second runner times
    the step inside the loop (epoch wall over its steps, after the epoch of
    the warm-up and capture), beside the eager step time, a step's device
    time and the busy share.  Each runner's graph must hold exactly
    `per_step` wrapper launches.  Returns the two runners."""
    loader = DataLoader(train, batch, drop_last=True)
    valid = DataLoader([train[i] for i in range(batch)], batch)
    steps = epochs * (len(train) // batch)

    def runner_of(model, opt, train_step, eval_step):
        return DeviceEpochRunner(model, train_step, eval_step, opt, loader, valid,
                                 verbose=False)

    def check(runner, opt):
        got = dict(wrapper_launches(runner.kernels()))
        if (runner.eager_steps, runner.replays) != (2, steps - 2) or opt.count != steps:
            raise AssertionError(f"loop {tag}: {runner.eager_steps} eager steps, "
                                 f"{runner.replays} replays, count {opt.count} of {steps}")
        if got != per_step:
            raise AssertionError(f"loop {tag}: the captured step holds {got}, "
                                 f"expected {per_step}")
        return got

    with deterministic_cudnn():
        model, opt, train_step, eval_step = make("cuda")
        checked = runner_of(model, opt, train_step, eval_step)
        losses, _, _ = run_loop(checked, epochs)
        got = check(checked, opt)
        ref_model, _, ref_step, _ = make("cuda")
        before = getattr(ref_step, "before_step", None)   # as DeviceEpochRunner calls it
        ref_losses, eager_ms = [], []
        for _ in range(epochs):
            for host_batch in loader:
                if before is not None:
                    before()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = ref_step(host_batch)
                torch.cuda.synchronize()
                eager_ms.append((time.perf_counter() - t0) * 1e3)
                ref_losses.append([float(x) for x in out])
    ref_losses = np.asarray(ref_losses)

    def loss_gap(a):
        return float(np.max(np.abs(a - ref_losses) / np.maximum(np.abs(ref_losses), 1e-30)))

    param_gap, worst = 0.0, ""
    ref_state = ref_model.state_dict()
    for key, p in model.state_dict().items():
        err, scale = max_err(p.float(), ref_state[key].float())
        rel = err / scale if scale > 0 else err
        if rel > param_gap:
            param_gap, worst = rel, key
    gap = loss_gap(losses)
    bit_equal = gap == 0 and param_gap == 0
    with deterministic_cudnn():   # the captured eval step against an eager one
        graph_val = float(checked.validate())
        eager_val = float(eval_step(next(iter(valid))))
    val_gap = abs(graph_val - eager_val) / abs(eager_val)
    print(f"loop {tag}: {steps} steps ({checked.eager_steps} eager, {checked.replays} "
          f"replays of {len(checked.kernels())} device kernels) vs {steps} eager host-loop "
          f"steps, cuDNN deterministic: {'bit-equal' if bit_equal else 'not bit-equal'}; "
          f"losses max rel gap {gap:.3e} (tol {tol_loss:.1e}), weights max gap/max|w| "
          f"{param_gap:.3e} at {worst or '-'} (tol {tol_param:.1e}); captured "
          f"launches/step {got}; validation (captured eval step) {graph_val:.6e} vs eager "
          f"{eager_val:.6e}, rel gap {val_gap:.3e}")
    if not (np.isfinite(losses).all() and gap <= tol_loss and param_gap <= tol_param
            and val_gap <= tol_loss):
        raise AssertionError(f"loop {tag}: the device loop and the host loop disagree")

    model, opt, train_step, eval_step = make("cuda")
    runner = runner_of(model, opt, train_step, eval_step)
    losses, loop_ms, val_ms = run_loop(runner, epochs)
    check(runner, opt)
    timed = loop_ms[1:]
    step_ms = statistics.median(timed)
    dev_ms = device_ms(lambda: runner.train_epoch(epochs)) / runner.n_batches
    eager = statistics.median(eager_ms[2:])
    print(f"loop {tag}, cuDNN defaults: losses max rel gap to the deterministic host loop "
          f"{loss_gap(losses):.3e}; median step in the loop {step_ms:.3f} ms over "
          f"{len(timed)} epochs (min {min(timed):.3f}, max {max(timed):.3f}), eager "
          f"host-loop step {eager:.3f} ms ({eager / step_ms:.2f}x), device time "
          f"{dev_ms:.3f} ms/step (busy {100 * dev_ms / step_ms:.1f} %), validation "
          f"{statistics.median(val_ms):.2f} ms, {points / step_ms * 1e3:.4e} grid-points/s")
    print(f"  breakdown loop {tag} (one epoch of {runner.n_batches} replays): "
          f"{breakdown(lambda: runner.train_epoch(epochs + 1))}")
    return [checked, runner]


def device_loop_phase():
    """The device-loop path of training (``train/device_loop.py``): the ex1
    step (both attention types, float32 and bfloat16) and the ex2 step
    (float32 and bfloat16) through `DeviceEpochRunner` on the training
    phases' datasets, each against the eager host loop.  Returns the launch
    counts of its run, the graph replays' included."""
    reset_launches()
    runners = []
    train = ex1_train_data()
    for dtype in DTYPES:
        for attention_type in ATTENTION_TYPES:
            tag = f"ex1 {attention_type} {dtype_name(dtype)} n={TRAIN_N} batch={BATCH}"
            runners.extend(loop_case(
                tag, lambda device: ex1_step(device, dtype, attention_type), train, BATCH,
                LAUNCHES_PER_STEP[attention_type, dtype],
                LOOP_EPOCHS["ex1"], TOL_LOOP if dtype is None else TOL_TRAIN_LOSS_BF16,
                TOL_LOOP if dtype is None else TOL_TRAIN_GRAD_BF16, BATCH * TRAIN_N))
    train_2d, batches, normalizer, (n_f, n_c) = ex2_train_data()
    cfg = {**ex2_config(n_f, n_c), **NO_DROPOUT}
    for dtype in DTYPES:
        fwd, bwd = (("galerkin_scores", "galerkin_scores_bwd") if dtype is None else
                    ("galerkin_scores_bf16", "galerkin_scores_bwd_bf16"))
        n_layers = cfg["num_encoder_layers"]
        tag = f"ex2 galerkin {dtype_name(dtype)} (n_f,n_c)=({n_f},{n_c}) batch={BATCH_2D}"
        runners.extend(loop_case(
            tag, lambda device: ex2_step(device, dtype, cfg, batches, normalizer, n_f,
                                         steps=True), train_2d, BATCH_2D,
            {fwd: n_layers, bwd: n_layers}, LOOP_EPOCHS["ex2"],
            TOL_LOOP if dtype is None else TOL_TRAIN_LOSS_BF16,
            TOL_LOOP if dtype is None else TOL_TRAIN_GRAD_BF16, BATCH_2D * n_f * n_f))
    counts = Counter(launches())
    counts.update(runner_launches(runners))
    return {name: counts[name] for name in COUNTERS}


# recovery phase (the full-width ex1 galerkin step, f32, 4 steps an epoch): the
# weights are multiplied by 1e4 from the host before epoch RECOVERY_SPIKE (the
# first of a block of 2), so that it spikes; RECOVERY_EPOCHS leaves a block of
# 2 after the rollback.  Then RESUME_EPOCHS more from the best checkpoint, and
# PLATEAU_EPOCHS under the plateau scheduler, whose controller (patience 1, a
# relative threshold of 1/2 that hardly an epoch meets) cuts the lr every
# other epoch
RECOVERY_EPOCHS = 7
RECOVERY_SPIKE = 4
RECOVERY_DISPATCH = 2
RESUME_EPOCHS = 2
PLATEAU_EPOCHS = 5
PLATEAU_LR = 1e-4     # constant from the first step: 1e-3 drives this small set off
TIMED_LOOP_EPOCHS = 3


@contextlib.contextmanager
def runner_hooks(before_epoch=None, eager=False):
    """Record every `DeviceEpochRunner` made in the block; call
    ``before_epoch(runner, epoch_idx)`` before each of its epochs; with
    `eager` run its steps eagerly on the current stream (no capture): the
    same loop, each step launched from the host, the reference that a
    captured run is held to."""
    made = []
    init, train_epoch = DeviceEpochRunner.__init__, DeviceEpochRunner.train_epoch

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if eager:
            self.graphed = False
            self._train.stream = self._eval.stream = None
        made.append(self)

    def hooked_train_epoch(self, epoch_idx):
        if before_epoch is not None:
            before_epoch(self, epoch_idx)
        return train_epoch(self, epoch_idx)

    DeviceEpochRunner.__init__ = recording_init
    DeviceEpochRunner.train_epoch = hooked_train_epoch
    try:
        yield made
    finally:
        DeviceEpochRunner.__init__, DeviceEpochRunner.train_epoch = init, train_epoch


def poison(model):
    """Every weight ×1e4, in place, from the host."""
    with torch.no_grad():
        torch._foreach_mul_(list(model.parameters()), 1e4)


def run_recorded(make, step_of=None, **kwargs):
    """`run_train` of the model, optimizer and steps that ``make()`` builds
    (``step_of(train_step, model)`` wraps the train step), with the
    optimizer's schedule as the lr history, its printout kept and printed:
    (best state_dict, TrainResult, model, optimizer, printout)."""
    model, opt, train_step, eval_step = make()
    if step_of is not None:
        train_step = step_of(train_step, model)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        best, result = run_train(model, train_step, eval_step, opt,
                                 lr_schedule=getattr(opt, "lr_schedule", None), **kwargs)
    print(printed.getvalue(), end="")
    return best, result, model, opt, printed.getvalue()


def assert_same_run(tag, got, want):
    """Two `run_recorded` results bit for bit: per-epoch losses, validation,
    lr history, the best and the final weights."""
    (best, res, model, _, _), (best_ref, res_ref, model_ref, _, _) = got, want
    for name in ("loss_train", "loss_val", "lr_history"):
        a, b = np.asarray(getattr(res, name)), np.asarray(getattr(res_ref, name))
        if a.shape != b.shape or not np.array_equal(a, b, equal_nan=True):
            raise AssertionError(f"recovery {tag}: {name} differs: {a} vs {b}")
    for what, sd, ref in (("best", best, best_ref),
                          ("final", model.state_dict(), model_ref.state_dict())):
        for key, w in sd.items():
            if not torch.equal(w, ref[key]):
                raise AssertionError(f"recovery {tag}: {what} weights differ at {key}")
    print(f"recovery {tag}: bit-equal ({len(res.loss_train)} epochs: losses, validation, "
          f"lr history, best and final weights)")


def recovery_phase(smi: str):
    """Training recovery in the device loop at full ex1 width (galerkin, f32,
    batch 8, n = 2048, cuDNN deterministic), each captured run against the
    same run with eager steps:

      * rollback, 2 epochs per host read: the weights ×1e4 from the host
        between two blocks, so that the next block spikes; right after the
        rollback the Adam moments are zero, ``lr_scale`` is 0.5 and the
        captured graph is the one from before the spike; every later step
        is a replay of it (no capture after the warm-up); the losses after
        the rollback are finite; bit-equal to the same loop with eager steps
        (the spiked block's second epoch is thrown away and still counted,
        as in JAX), and with 1 epoch per read bit-equal to the eager host
        loop (`run_train(device_loop=False)`) with the same poisoning;
      * resume from the rollback run's best checkpoint for RESUME_EPOCHS
        epochs, in the loop and in the eager host loop: bit-equal;
      * `AdamPlateau` with a controller that cuts the lr inside the run, in
        the loop and in the eager host loop: bit-equal, a reduction before
        the last epoch;
      * the step time in the loop for each optimizer, with the card.

    Returns the launch counts of the phase, the graph replays' included."""
    reset_launches()
    train = ex1_train_data()
    loader = DataLoader(train, BATCH, drop_last=True)
    valid = DataLoader([train[i] for i in range(BATCH)], BATCH)
    n_batches = len(loader)
    graphed = []

    def make(optimizer="onecycle"):
        model, opt, train_step, eval_step = ex1_step("cuda", None, "galerkin")
        if optimizer == "plateau":
            opt = AdamPlateau(model.parameters(), PLATEAU_LR, grad_clip=0.999)
            train_step, eval_step = make_burgers_steps(
                model, WeightedL2Loss(regularizer=True, h=1 / TRAIN_N, gamma=0.1),
                WeightedL2Loss(h=1 / TRAIN_N), opt)
        return model, opt, train_step, eval_step

    def host_poisoned(train_step, model):
        """The host loop's poisoning: before its first step of epoch
        RECOVERY_SPIKE."""
        calls = [0]

        def step(batch):
            if calls[0] == RECOVERY_SPIKE * n_batches:
                poison(model)
            calls[0] += 1
            return train_step(batch)
        step.generators = train_step.generators
        return step

    def rollback_run(path, k, eager):
        """The rollback run with k epochs per host read: the captured loop,
        the loop with eager steps (k > 1) or the eager host loop (k = 1).
        Returns (run_recorded's result, what the hook saw, the runner)."""
        seen = {}

        def before(runner, epoch_idx):
            opt = runner.optimizer
            if epoch_idx == RECOVERY_SPIKE and "graph" not in seen:
                seen["graph"] = runner._train.graph
                poison(runner.model)
            if opt.lr_scale != 1.0 and "after" not in seen:   # the first epoch after it
                moments = [t for st in opt.state.values() for t in st.values()]
                seen["after"] = dict(
                    epoch=epoch_idx, zero=all(not t.any() for t in moments),
                    scale=opt.lr_scale, graph=runner._train.graph,
                    table=torch.equal(opt._table, opt._host_table().to(opt._table.device)))

        kw = dict(train_loader=loader, valid_loader=valid, epochs=RECOVERY_EPOCHS,
                  patience=None, rollback_on_spike=10.0, model_save_path=path)
        if k == 1 and eager:
            return run_recorded(make, host_poisoned, device_loop=False, **kw), seen, None
        with runner_hooks(before, eager=eager) as made:
            run = run_recorded(make, device_loop=True, epochs_per_dispatch=k, **kw)
        return run, seen, made[0]

    with tempfile.TemporaryDirectory() as tmp, deterministic_cudnn():
        best_ckpt = {}
        for k in (RECOVERY_DISPATCH, 1):
            paths = {eager: os.path.join(tmp, f"rollback_k{k}_{eager}") for eager in (0, 1)}
            run, seen, runner = rollback_run(paths[0], k, eager=False)
            reference, _, _ = rollback_run(paths[1], k, eager=True)
            graphed.append(runner)
            best_ckpt[k] = os.path.join(paths[0], "model.ckpt")
            _, res, _, opt, printed = run
            after, spike = seen.get("after"), RECOVERY_SPIKE + 1
            trained = RECOVERY_EPOCHS + (k - 1)    # the spiked block's thrown-away epoch
            checks = {
                "one rollback, at the poisoned epoch":
                    printed.count("rolled back") == 1
                    and f"loss spike at epoch {spike} " in printed,
                "moments zero and lr_scale 0.5 right after it":
                    after is not None and after["zero"] and after["scale"] == 0.5
                    and after["table"] and opt.lr_scale == 0.5,
                "the same captured graph after it":
                    after is not None and seen["graph"] is not None
                    and after["graph"] is seen["graph"] is runner._train.graph,
                "every later step a replay":
                    (runner.eager_steps, runner.replays) == (2, trained * n_batches - 2)
                    and opt.count == trained * n_batches,
                "finite losses after it": bool(np.isfinite(res.loss_train[spike:]).all()),
            }
            failed = [name for name, ok in checks.items() if not ok]
            print(f"recovery rollback, {k} epoch(s) per host read: spike at epoch {spike}, "
                  f"{runner.eager_steps} eager steps + {runner.replays} replays of one graph; "
                  f"right after the rollback (epoch {after and after['epoch']}): moments "
                  f"zero {after and after['zero']}, lr_scale {after and after['scale']}; "
                  f"checks failed: {failed}")
            if failed:
                raise AssertionError(f"recovery rollback k={k}: {failed}")
            assert_same_run(f"rollback, {k} epoch(s) per host read, against "
                            + ("the loop with eager steps" if k > 1 else "the eager host loop"),
                            run, reference)

        resumed = {}
        for device_loop in (True, False):
            path = os.path.join(tmp, f"resume_{device_loop}")
            os.makedirs(path)
            shutil.copy(best_ckpt[RECOVERY_DISPATCH], os.path.join(path, "model.ckpt"))
            with runner_hooks() as made:
                resumed[device_loop] = run_recorded(
                    make, train_loader=loader, valid_loader=valid,
                    epochs=RECOVERY_EPOCHS + RESUME_EPOCHS, start_epoch=RECOVERY_EPOCHS,
                    resume=True, patience=None, rollback_on_spike=10.0,
                    model_save_path=path, device_loop=device_loop,
                    epochs_per_dispatch=RECOVERY_DISPATCH if device_loop else 1)
            graphed.extend(made)
            if "resumed params + optimizer state" not in resumed[device_loop][4]:
                raise AssertionError("recovery resume: the checkpoint was not read")
        saved = torch.load(best_ckpt[RECOVERY_DISPATCH], weights_only=True)["optimizer"]
        group = saved["param_groups"][0]
        for opt in (resumed[True][3], resumed[False][3]):
            if (opt.lr_scale, opt.count) != (group["lr_scale"],
                                             group["count"] + RESUME_EPOCHS * n_batches):
                raise AssertionError(f"recovery resume: lr_scale {opt.lr_scale}, count "
                                     f"{opt.count}; the checkpoint's {group}")
        assert_same_run(f"resume for {RESUME_EPOCHS} epochs against the eager host loop",
                        resumed[True], resumed[False])

        plateau_runs = {}
        for device_loop in (True, False):
            plateau = PlateauController(PLATEAU_LR, factor=0.5, patience=1, threshold=0.5)
            path = os.path.join(tmp, f"plateau_{device_loop}")
            with runner_hooks() as made:
                plateau_runs[device_loop] = run_recorded(
                    lambda: make("plateau"), train_loader=loader, valid_loader=valid,
                    epochs=PLATEAU_EPOCHS, patience=None, plateau=plateau,
                    model_save_path=path, device_loop=device_loop)
            graphed.extend(made)
            lrs = [json.loads(line)["lr"] for line in open(os.path.join(path, "result.jsonl"))]
            if not min(lrs[:-1]) < lrs[0] or plateau_runs[device_loop][3].lr != plateau.lr:
                raise AssertionError(f"recovery plateau: no reduction before the last "
                                     f"epoch: {lrs}")
        print(f"recovery plateau: lr after each epoch {lrs}")
        assert_same_run("plateau against the eager host loop", plateau_runs[True],
                        plateau_runs[False])

    step_ms = {}
    for name, runner in (("AdamOneCycle", graphed[0]), ("AdamPlateau", graphed[-1])):
        _, loop_ms, _ = run_loop(runner, TIMED_LOOP_EPOCHS)
        step_ms[name] = statistics.median(loop_ms)
    print(f"recovery: median step in the loop (ex1 galerkin f32, batch {BATCH}, "
          f"n={TRAIN_N}, {TIMED_LOOP_EPOCHS} epochs of {n_batches} replays), "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in step_ms.items()) + f"; card: {smi}")
    counts = Counter(launches())
    counts.update(runner_launches(graphed))
    return {name: counts[name] for name in COUNTERS}


@contextlib.contextmanager
def fresh_data_dir():
    """An empty data directory for the block: the datasets made in it are
    made afresh (and their making timed), not read from a cache."""
    old = port_config.DATA_PATH
    with tempfile.TemporaryDirectory() as tmp:
        port_config.DATA_PATH = tmp
        try:
            yield tmp
        finally:
            port_config.DATA_PATH = old


def ex4_train_data():
    """The ex4 training set of the training phases, made afresh by the torch
    generator on the card, and its shuffled batches of BATCH_2D."""
    with fresh_data_dir():
        t0 = time.perf_counter()
        train = NavierStokesDatasetLite(n_samples_synthetic=EX4_SAMPLES)
        made = time.perf_counter() - t0
    print(f"NavierStokesDatasetLite: {len(train)} trajectories of {EX4_WINDOW} + {EX4_WINDOW} "
          f"steps at {EX4_GRID}^2 from the torch generator on the card in {made:.2f} s")
    return train, list(DataLoader(train, BATCH_2D, shuffle=True, drop_last=True, seed=SEED))


def ex4_step(device, config):
    """The full-width ex4 FourierTransformer2DLite, its optimizer and its
    `make_ns_steps` steps (a 10-step rollout)."""
    model = FourierTransformer2DLite.from_config(config, device=device, seed=SEED)
    opt = AdamOneCycle(model.parameters(), 1e-3, 100 * (EX4_SAMPLES // BATCH_2D),
                       grad_clip=0.99)
    h = 1 / EX4_GRID
    return (model, opt) + make_ns_steps(
        model, WeightedL2Loss2d(regularizer=True, h=h, gamma=0.1), WeightedL2Loss2d(h=h), opt,
        time_steps=EX4_WINDOW)


def ex4_phase():
    """The fifth main path, trained: one `make_ns_steps` step of the
    full-width ex4 model (a 10-step rollout and one backward through all of
    it) on the card and on the CPU from the same weights with dropout off;
    timed eager steps with the config's dropout; then the step through
    `DeviceEpochRunner` (the whole rollout and its backward one captured
    graph) against the eager host loop.  No kernel of the port may launch.
    Returns the launch counts of the run, the replays' included."""
    reset_launches()
    train, batches = ex4_train_data()
    cfg = load_config("ex4_navier_stokes")
    steps, models = {}, {}
    for device in ("cuda", "cpu"):
        models[device], _, steps[device], _ = ex4_step(device, {**cfg, **NO_DROPOUT})
    same_weights(models["cuda"], models["cpu"])
    tag = f"ex4 galerkin f32 n={EX4_GRID}^2 rollout={EX4_WINDOW} batch={BATCH_2D}"
    points = BATCH_2D * EX4_GRID ** 2 * EX4_WINDOW   # grid points through the model a step
    compare_step(tag, steps, models, batches[0], {}, TOL_TRAIN_LOSS, TOL_TRAIN_GRAD)
    del steps, models
    _, _, step, _ = ex4_step("cuda", cfg)   # the config's ffn dropout
    time_steps(tag + " config dropout", step, batches, TRAIN_2D_STEPS, points)
    runners = loop_case(tag, lambda device: ex4_step(device, {**cfg, **NO_DROPOUT}), train,
                        BATCH_2D, {}, LOOP_EPOCHS["ex4"], TOL_LOOP, TOL_LOOP, points)
    counts = Counter(launches())
    counts.update(runner_launches(runners))
    if any(counts.values()):
        raise AssertionError(f"ex4: the port's kernels launched {dict(counts)}")
    return {name: counts[name] for name in COUNTERS}


def _driver_outputs(tag, tmp, val, epochs):
    logs = [json.loads(line) for f in glob.glob(os.path.join(tmp, "*.jsonl"))
            for line in open(f)]
    ckpts = glob.glob(os.path.join(tmp, "*.ckpt"))
    if not (math.isfinite(val) and len(logs) == epochs and len(ckpts) == 1
            and all(math.isfinite(x) for e in logs for x in e["loss"])):
        raise AssertionError(f"driver {tag}: val={val}, epochs logged {len(logs)}, "
                             f"checkpoints {ckpts}")
    return ckpts[0]


def driver_phase():
    """The port's entry points: ex1 (galerkin, softmax, and galerkin on
    nonuniform meshes), ex2 and ex4 for 2 epochs, each best checkpoint
    served, and ex3 for 1 epoch.  The Darcy drivers run on a
    small synthetic grid at the configs' widths, ex4 on a few trajectories
    at its own grid and width.  Returns the launch
    counts of the run, the device loop's graph replays included (the drivers
    run it by default)."""
    reset_launches()
    with runner_hooks() as runners:
        counts, served = _drive()
    counts = Counter(counts)
    counts.update(forward_launches(served))
    if len(runners) != 11 or any(r.replays == 0 for r in runners):
        raise AssertionError(f"driver: {len(runners)} device loops, replays "
                             f"{[r.replays for r in runners]}")
    counts.update(runner_launches(runners))
    return {name: counts[name] for name in COUNTERS}


def _drive():
    """The four drivers, each best checkpoint checked; the wrappers' launch
    counts of the run, and the served checkpoints' replayed forwards."""
    served = []
    valid = BurgersDataset(subsample=SUBSAMPLE, train_data=False, valid_portion=100,
                           n_samples_synthetic=TRAIN_SAMPLES)
    batch = next(iter(DataLoader(valid, 4)))
    with tempfile.TemporaryDirectory() as tmp:
        val = ex1_burgers.main(["--n-samples", str(TRAIN_SAMPLES), "--epochs", "2"],
                               model_save_path=tmp)
        ckpt = _driver_outputs("ex1", tmp, val, 2)
        cfg = load_config("ex1_burgers")
        pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, seed=1), ckpt)
        out = pred(batch)
        served.append(pred.captured(batch))
        if out.shape != (4, TRAIN_N, 1) or not np.isfinite(out).all():
            raise AssertionError(f"driver: served checkpoint gave {out.shape}")
        print(f"driver ex1: 2 epochs, best validation metric {val:.4e}; the best checkpoint "
              f"served a batch of {out.shape}")
        round_trip(ckpt, cfg, batch, out, served)
    for flags in (["--attention-type", "softmax"],
                  ["--nonuniform", "--attention-type", "galerkin"]):
        with tempfile.TemporaryDirectory() as tmp:
            val = ex1_burgers.main(["--n-samples", str(TRAIN_SAMPLES), "--epochs", "2"] + flags,
                                   model_save_path=tmp)
            ckpt = _driver_outputs(f"ex1 {' '.join(flags)}", tmp, val, 2)
            cfg = {**load_config("ex1_burgers"), "attention_type": flags[-1]}
            pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, seed=1), ckpt)
        valid = BurgersDataset(subsample=SUBSAMPLE, train_data=False, valid_portion=100,
                               n_samples_synthetic=TRAIN_SAMPLES,
                               uniform="--nonuniform" not in flags)
        batch = next(iter(DataLoader(valid, 4)))
        outs = [pred(batch) for _ in range(3)]   # eager and capture, then two replays
        served.append(pred.captured(batch))
        if (any(o.shape != (4, TRAIN_N, 1) or not np.isfinite(o).all() for o in outs)
                or not np.array_equal(outs[1], outs[2])):
            raise AssertionError(f"driver ex1 {flags}: served checkpoint gave {outs[0].shape}")
        print(f"driver ex1 {' '.join(flags)}: 2 epochs, best validation metric {val:.4e}; "
              f"the best checkpoint served a batch of {outs[0].shape}")
    # the recovery flags: rollback on a spike and the plateau scheduler, then
    # a resume from the run's checkpoint
    flags = ["--n-samples", str(TRAIN_SAMPLES), "--attention-type", "galerkin",
             "--rollback-on-spike", "10", "--scheduler", "plateau", "--lr", "1e-4"]
    with tempfile.TemporaryDirectory() as tmp:
        val = ex1_burgers.main(flags + ["--epochs", "2"], model_save_path=tmp)
        _driver_outputs("ex1 plateau", tmp, val, 2)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            val = ex1_burgers.main(flags + ["--epochs", "3", "--resume-epoch", "2"],
                                   model_save_path=tmp)
        print(printed.getvalue(), end="")
        _driver_outputs("ex1 plateau resumed", tmp, val, 3)
    if "resumed params + optimizer state" not in printed.getvalue():
        raise AssertionError("driver ex1 --resume-epoch: the checkpoint was not read")
    print(f"driver ex1 (galerkin, --rollback-on-spike 10 --scheduler plateau --lr 1e-4): "
          f"2 epochs, then --resume-epoch 2 for a third: best validation metric {val:.4e}")

    # zero-shot super-resolution: trained at n = 2048 and validated at 8192 (the
    # validation batches a second graph shape in the device loop), and the reverse
    for train_sub, eval_sub in ((SUBSAMPLE, 1), (1, SUBSAMPLE)):
        flags = ["--n-samples", str(TRAIN_SAMPLES), "--epochs", "2", "--train-subsample",
                 str(train_sub), "--eval-subsample", str(eval_sub)]
        with tempfile.TemporaryDirectory() as tmp:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                val = ex1_burgers_super_res.main(flags, model_save_path=tmp)
            print(printed.getvalue(), end="")
            _driver_outputs(f"ex1 super-res {train_sub}->{eval_sub}", tmp, val, 2)
        n_train, n_eval = 8192 // train_sub, 8192 // eval_sub
        line = (f"Zero-shot super-res validation metric (train n={n_train} -> eval "
                f"n={n_eval}): {val:.4e}")
        if line not in printed.getvalue():
            raise AssertionError(f"driver super-res: no line {line!r}")
        print(f"driver ex1 super-res (fourier f32, train n={n_train}, validate n={n_eval}): "
              f"2 epochs in the device loop, metric {val:.4e}")

    grid = ["--n-grid-fine", "61", "--subsample-nodes", "1", "--subsample-attn", "5",
            "--n-samples", "16"]
    n_f, n_c = 61, 13
    with tempfile.TemporaryDirectory() as tmp:
        val = ex2_darcy.main(grid + ["--epochs", "2", "--bf16"], model_save_path=tmp)
        ckpt = _driver_outputs("ex2", tmp, val, 2)
        cfg = load_config("ex2_darcy")
        cfg["downscaler_size"], cfg["upscaler_size"] = get_scaler_sizes(n_f, n_c)
        pred = Predictor.from_checkpoint(
            FourierTransformer2D.from_config(cfg, seed=1, dtype=torch.bfloat16), ckpt)
    if pred.normalizer is None or pred.normalizer[0].shape != (n_f, n_f, 1):
        raise AssertionError("driver ex2: the checkpoint carried no normalizer")
    pos, fine = darcy_grids(n_f, n_c)
    node = np.random.default_rng(SEED).standard_normal((4, n_f, n_f, 1)).astype(np.float32)
    batch = dict(node=node, pos=pos[None].repeat(4, 0), grid=fine[None].repeat(4, 0))
    out = pred(batch)
    served.append(pred.captured(batch))
    if (out.shape != (4, n_f, n_f, 1) or not np.isfinite(out).all() or out[:, 0].any()
            or out[:, :, -1].any() or not out[:, 1:-1, 1:-1].any()):
        raise AssertionError(f"driver ex2: served checkpoint gave {out.shape}")
    print(f"driver ex2 (bf16, (n_f,n_c)=({n_f},{n_c})): 2 epochs, best validation metric "
          f"{val:.4e}; the best checkpoint served a batch of {out.shape} with its "
          f"normalizer, zero on the boundary")
    with tempfile.TemporaryDirectory() as tmp:
        val = ex3_darcy_inv.main(["--n-grid-fine", "61", "--subsample-nodes", "2",
                                  "--subsample-attn", "6", "--n-samples", "16",
                                  "--epochs", "1"], model_save_path=tmp)
        _driver_outputs("ex3", tmp, val, 1)
    print(f"driver ex3 (f32, inverse, 61 grid): 1 epoch, validation metric {val:.4e}")
    # ex4 makes its data afresh: the training set by the torch generator on
    # the card, the validation set (max(n // 4, 4) trajectories, under the
    # device threshold) by the host solver; the dataset prints each time
    with tempfile.TemporaryDirectory() as tmp, fresh_data_dir():
        t0 = time.perf_counter()
        val = ex4_navier_stokes.main(["--n-samples", str(EX4_SAMPLES), "--epochs", "2"],
                                     model_save_path=tmp)
        run_s = time.perf_counter() - t0
        ckpt = _driver_outputs("ex4", tmp, val, 2)
        pred = Predictor.from_checkpoint(FourierTransformer2DLite.from_config(
            load_config("ex4_navier_stokes"), seed=1), ckpt)
        valid = NavierStokesDatasetLite(train_data=False,
                                        n_samples_synthetic=max(EX4_SAMPLES // 4, 4))
        path = os.path.join(tmp, "plateau")   # the same data, from the cache
        val_plateau = ex4_navier_stokes.main(["--n-samples", str(EX4_SAMPLES), "--epochs", "2",
                                              "--scheduler", "plateau"], model_save_path=path)
        _driver_outputs("ex4 plateau", path, val_plateau, 2)
    batch = next(iter(DataLoader(valid, BATCH_2D)))
    outs = [pred(batch) for _ in range(3)]   # eager and capture, then two replays
    served.append(pred.captured(batch))
    if (any(o.shape != (BATCH_2D, EX4_GRID, EX4_GRID, 1) or not np.isfinite(o).all()
            for o in outs) or not np.array_equal(outs[1], outs[2])
            or pred.captured(batch).replays != 2):
        raise AssertionError(f"driver ex4: served checkpoint gave {outs[0].shape}")
    print(f"driver ex4 (f32, {EX4_SAMPLES} trajectories at {EX4_GRID}^2): 2 epochs in "
          f"{run_s:.1f} s with the data, best validation metric {val:.4e}; the best "
          f"checkpoint served a validation batch of {outs[0].shape} (2 replays); "
          f"--scheduler plateau: best validation metric {val_plateau:.4e}")
    return launches(), served


# the ex1 attention types without a kernel: served at both resolutions (the
# SimpleAttention types in float32 and bfloat16, the vanilla `official` stack
# in float32, as JAX gives it no compute type), trained for a step against the
# CPU and in the device loop (float32)
EX1_VARIANTS = ("linear", "softmax", "cosine", "official")
VARIANT_LOOP_EPOCHS = 4
# their gradients against the CPU: a softmax over the sequence (linear, softmax)
# or over the keys (the vanilla stack) does not see a shift of K, so the
# gradient of K's LN bias (or key bias) is zero in exact arithmetic, and the
# softmax over nearly equal features leaves others at ~1e-7 of the model's
# largest: float32 roundoff of terms of the largest size sets their error, so
# each is held against at least 1e-3 of the model's largest gradient
GRAD_FLOOR = 1e-3
# masked SimpleAttention calls at the ex1 width: (B, n, n) score masks for
# fourier and softmax, the (B, n) key mask for causal
MASKED_TYPES = ("fourier", "softmax", "causal")
# causal attention on layer-normalized features: the rows whose denominator
# loses at most this many float32 steps to cancellation are held to float64
CAUSAL_KAPPA = 1e2


def masks_phase(rng, n=TRAIN_N):
    """Masked `SimpleAttention` calls on the card against the CPU, to
    TOL_SERVE of the largest output (no kernel: fourier with a mask forms
    its dense scores).  Causal linear attention divides by q·Σk, which
    passes near zero for signed features, so the layer runs as linear
    attentions are meant to, on positive features: no norm, positive q and
    k projections and inputs; `causal_witness` holds it on layer-normalized
    features against float64."""
    x = torch.from_numpy(rng.standard_normal((BATCH, n, 96)).astype(np.float32))
    pos = torch.linspace(0, 1, n)[None, :, None].expand(BATCH, n, 1).contiguous()
    scores = torch.from_numpy((rng.random((BATCH, n, n)) > 0.3).astype(np.float32))
    keys = torch.ones(BATCH, n)
    keys[:, -n // 8:] = 0.0
    for atype in MASKED_TYPES:
        causal = atype == "causal"
        layer = SimpleAttention(n_head=1, d_model=96, attention_type=atype, norm=not causal,
                                xavier_init=1e-2, diagonal_weight=1e-2, dropout=0.0).eval()
        inputs = (x.abs() if causal else x, pos)
        if causal:
            with torch.no_grad():
                for lin in layer.linears[:2]:
                    lin.weight.abs_()
        mask = keys if causal else scores
        with torch.no_grad():
            want, _ = layer(inputs[0], inputs[0], inputs[0], inputs[1], mask=mask)
            before = launches()
            xs, ps = (t.cuda() for t in inputs)
            got, _ = layer.to("cuda")(xs, xs, xs, ps, mask=mask.cuda())
            torch.cuda.synchronize()
        if launches() != before:
            raise AssertionError(f"masked {atype}: a kernel was launched")
        got = got.cpu()
        err, scale = float((got - want).abs().max()), float(want.abs().max())
        print(f"masked {atype} SimpleAttention (d=96, n={n}, batch={BATCH}"
              f"{', positive features' if causal else ''}): card vs CPU max_abs_err={err:.3e} "
              f"scale={scale:.3e} tol={TOL_SERVE:.1e}; no kernel")
        if not (err <= TOL_SERVE * scale and torch.isfinite(got).all()):
            raise AssertionError(f"masked {atype}: the card and the CPU disagree")
    causal = SimpleAttention(n_head=1, d_model=x.shape[-1], attention_type="causal", norm=True,
                             xavier_init=1e-2, diagonal_weight=1e-2, dropout=0.0).eval()
    causal_witness("causal SimpleAttention with its norm", causal, x, x, pos, keys)


def causal_kappa(attn, query, memory, pos, keys):
    """κ_t of the rows of the causal `SimpleAttention` `attn` with its norm
    (the largest over its heads, (b, n)), in float64 on the CPU from its
    query input, the memory its keys come from, pos and the key mask
    `keys`, q and k formed as the layer forms them (per-head LN, the pos
    columns in front).  Its denominator q_t·Σ_{s<=t} k_s sums signed
    terms, so row t loses about κ_t = Σ|q_t|·Σ|k_s| / |q_t·Σk_s| float32
    steps."""
    a = copy.deepcopy(attn).cpu().double()
    b, n, _ = query.shape
    h, d_k = a.n_head, a.d_k
    p64 = pos.cpu().double()[:, None].expand(b, h, n, pos.shape[-1])
    with torch.no_grad():
        q, k = (torch.cat([p64, a._head_norm(lin(t.cpu().double()).reshape(b, n, h, d_k)
                                             .transpose(1, 2), name)], -1)
                for lin, name, t in zip(a.linears[:2], ("Q", "K"), (query, memory)))
    km = k * keys.cpu().double()[:, None, :, None] / n
    den = torch.einsum("bhnd,bhnd->bhn", km.cumsum(2), q)
    return (torch.einsum("bhnd,bhnd->bhn", km.abs().cumsum(2), q.abs()) / den.abs()).amax(1)


def causal_witness(tag, attn, query, memory, pos, keys):
    """The causal `SimpleAttention` `attn` with its norm on the query input
    `query`, keys and values from `memory`, `pos` and the key mask `keys`,
    in float32 on the card and on the CPU, each against float64 on the CPU:
    over the rows with κ_t <= CAUSAL_KAPPA (`causal_kappa`) both must be
    within TOL_SERVE of the float64 output there, of its largest entry;
    over all rows both errors are printed.  Returns κ and the two errors on
    those rows."""
    kappa = causal_kappa(attn, query, memory, pos, keys)
    well = kappa <= CAUSAL_KAPPA
    outs = {}
    with torch.no_grad():
        for side, dev, dtype in (("float64", "cpu", torch.float64), ("CPU", "cpu", torch.float32),
                                 ("card", "cuda", torch.float32)):
            layer = copy.deepcopy(attn).to(dev, dtype)
            qs, ms, ps, ks = (t.to(dev, dtype) for t in (query, memory, pos, keys))
            outs[side] = layer(qs, ms, ms, ps, mask=ks)[0].cpu().double()
    ref, errs = outs["float64"], {}
    for side in ("card", "CPU"):
        if not torch.isfinite(outs[side]).all():
            raise AssertionError(f"{tag} witness: the {side} output is not finite")
        gap = (outs[side] - ref).abs().amax(-1)
        errs[side] = (float(gap.max() / ref.abs().max()),
                      float(gap[well].max() / ref[well].abs().max()))
    b, n, d = query.shape
    print(f"{tag} (d={d}, n={n}, batch={b}) vs float64, of the largest output: all rows card "
          f"{errs['card'][0]:.3e}, CPU {errs['CPU'][0]:.3e}; the "
          f"{100 * well.double().mean():.1f} % of rows with κ <= {CAUSAL_KAPPA:.0e} card "
          f"{errs['card'][1]:.3e}, CPU {errs['CPU'][1]:.3e} (tol {TOL_SERVE:.1e}); κ from "
          f"{kappa.min():.3e}, median {kappa.median():.3e}, to {kappa.max():.3e}")
    if not max(errs["card"][1], errs["CPU"][1]) <= TOL_SERVE:
        raise AssertionError(f"{tag} witness: a well-conditioned row is off float64")
    return kappa, {side: err[1] for side, err in errs.items()}


def cosine_bf16_phase(seeds=range(4)) -> list:
    """The readings behind TOL_SERVE_COSINE_BF16: on each seed (weights and
    batch) and resolution, the CPU's and the card's bf16 cosine models
    against the CPU's float32 model of the same weights, of its largest
    output (and the card's float32 model, for scale)."""
    cfg = {**load_config("ex1_burgers"), "attention_type": "cosine"}
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        preds = {(d, t): Predictor(SimpleTransformer.from_config(cfg, device=d, seed=seed,
                                                                  dtype=t), device=d)
                 for d in ("cpu", "cuda") for t in DTYPES}
        for n in RESOLUTIONS:
            batch = make_batch(rng, n)
            ref = preds["cpu", None](batch)
            row = {"seed": seed, "n": n}
            for (d, t), pred in preds.items():
                if (d, t) != ("cpu", None):
                    row[f"{d}_{dtype_name(t)}"] = float(np.abs(pred(batch) - ref).max()
                                                        / np.abs(ref).max())
            print(f"cosine vs the CPU's float32 model: {row}")
            rows.append(row)
    return rows + cosine_bf16_2d_readings(seeds)


def cosine_bf16_2d_readings(seeds) -> list:
    """The same for the 2D model (ex2 width, (n_f, n_c) = GRIDS_2D[0], batch
    4, a random normalizer), each distance of the largest entry of the CPU
    float32 model's own part (the interior with the normalizer undone), and
    the card's bf16 model against the CPU's bf16 model."""
    n_f, n_c = GRIDS_2D[0]
    cfg = {**ex2_config(n_f, n_c), "attention_type": "cosine"}
    pos, grid = darcy_grids(n_f, n_c)
    rows = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        mean = (0.1 * rng.standard_normal((n_f, n_f, 1))).astype(np.float32)
        std = rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32)
        normalizer = (mean, std, np.float32(1e-5))
        batch = dict(node=rng.standard_normal((BATCH_2D, n_f, n_f, 1)).astype(np.float32),
                     pos=pos[None].repeat(BATCH_2D, 0), grid=grid[None].repeat(BATCH_2D, 0))
        outs = {(d, t): Predictor(FourierTransformer2D.from_config(cfg, device=d, seed=seed,
                                                                   dtype=t),
                                  normalizer=normalizer, device=d)(batch)
                for d in ("cpu", "cuda") for t in DTYPES}

        def part(out):
            return ((out - mean) / (std + 1e-5))[:, 1:-1, 1:-1]

        scale = float(np.abs(part(outs["cpu", None])).max())
        row = {"model": "ex2", "seed": seed, "n_f": n_f}
        for (d, t), out in outs.items():
            if (d, t) != ("cpu", None):
                row[f"{d}_{dtype_name(t)}"] = float(
                    np.abs(part(out) - part(outs["cpu", None])).max() / scale)
        row["cuda_bf16_vs_cpu_bf16"] = float(
            np.abs(part(outs["cuda", torch.bfloat16]) - part(outs["cpu", torch.bfloat16])).max()
            / scale)
        print(f"ex2 cosine vs the CPU's float32 model: {row}")
        rows.append(row)
        release_graphs()
    return rows


def ex1_variants_phase(rng):
    """The rest of the ex1 model on the card (``SimpleTransformer`` at full
    width, random weights): the types without a kernel served, trained
    against the CPU and in the device loop; the galerkin step with its
    latents' orthogonality penalty in the device loop; per-sample
    nonuniform meshes (`BurgersDataset(uniform=False)`) through the galerkin
    and fourier kernels, trained in the device loop in float32 and bfloat16
    with the launches read from the graph, each step held against the CPU,
    and served; masked attention.  (The ex1 driver with ``--attention-type
    softmax`` and with ``--nonuniform`` runs in `driver_phase`.)  Returns
    the launch counts of its run."""
    reset_launches()
    t0 = time.perf_counter()
    replayed, runners = [], []
    for atype in EX1_VARIANTS:
        cfg = load_config("ex1_burgers")
        cfg["attention_type"] = atype
        for dtype in (None,) if atype == "official" else DTYPES:
            gpu = Predictor(SimpleTransformer.from_config(cfg, device="cuda", seed=SEED,
                                                          dtype=dtype))
            tol, ref_dtype = (TOL_SERVE, None) if dtype is None else (TOL_SERVE_BF16, dtype)
            if dtype is not None and atype == "cosine":   # against float32
                tol, ref_dtype = TOL_SERVE_COSINE_BF16, None
            cpu = Predictor(SimpleTransformer.from_config(cfg, device="cpu", seed=SEED,
                                                          dtype=ref_dtype), device="cpu")
            same_weights(gpu, cpu)
            for n in RESOLUTIONS:
                batches = [make_batch(rng, n) for _ in range(REQUESTS)]
                serve_and_check(f"ex1 {atype} {dtype_name(dtype)} n={n} batch={BATCH}", gpu, cpu,
                                batches, None, 0, BATCH * n, (BATCH, n, 1), tol, replayed)
    print(f"ex1 variants: serving {time.perf_counter() - t0:.1f} s")

    train = ex1_train_data()
    batches = list(DataLoader(train, BATCH, shuffle=True, drop_last=True, seed=SEED))
    for atype in EX1_VARIANTS:
        steps, models = {}, {}
        for device in ("cuda", "cpu"):
            models[device], _, steps[device], _ = ex1_step(device, None, atype)
        tag = f"ex1 {atype} f32 n={TRAIN_N} batch={BATCH}"
        compare_step(tag, steps, models, batches[0], {}, TOL_TRAIN_LOSS, TOL_TRAIN_GRAD,
                     GRAD_FLOOR)
        runners.extend(loop_case(tag, lambda device: ex1_step(device, None, atype), train,
                                 BATCH, {}, VARIANT_LOOP_EPOCHS, TOL_LOOP, TOL_LOOP,
                                 BATCH * TRAIN_N))
    tag = f"ex1 galerkin f32 latents+orthogonal_reg n={TRAIN_N} batch={BATCH}"
    runners.extend(loop_case(tag, lambda device: ex1_step(device, None, "galerkin", True),
                             train, BATCH, LAUNCHES_PER_STEP["galerkin", None],
                             VARIANT_LOOP_EPOCHS, TOL_LOOP, TOL_LOOP, BATCH * TRAIN_N))
    print(f"ex1 variants: + training {time.perf_counter() - t0:.1f} s")

    mesh = BurgersDataset(subsample=SUBSAMPLE, train_data=True, train_portion=0.5,
                          n_samples_synthetic=TRAIN_SAMPLES, uniform=False)
    loader = list(DataLoader(mesh, BATCH, shuffle=True, drop_last=True, seed=SEED))
    for dtype in DTYPES:
        for atype in ATTENTION_TYPES:
            tag = f"ex1 {atype} {dtype_name(dtype)} nonuniform n={TRAIN_N} batch={BATCH}"
            steps, models = {}, {}
            for device in ("cuda", "cpu"):
                models[device], _, steps[device], _ = ex1_step(device, dtype, atype)
            compare_step(tag, steps, models, loader[0], LAUNCHES_PER_STEP[atype, dtype],
                         TOL_TRAIN_LOSS if dtype is None else TOL_TRAIN_LOSS_BF16,
                         TOL_TRAIN_GRAD if dtype is None else TOL_TRAIN_GRAD_BF16)
            runners.extend(loop_case(
                tag, lambda device: ex1_step(device, dtype, atype), mesh, BATCH,
                LAUNCHES_PER_STEP[atype, dtype], VARIANT_LOOP_EPOCHS,
                TOL_LOOP if dtype is None else TOL_TRAIN_LOSS_BF16,
                TOL_LOOP if dtype is None else TOL_TRAIN_GRAD_BF16, BATCH * TRAIN_N))
    cfg = {**load_config("ex1_burgers"), "attention_type": "galerkin"}
    gpu, cpu = (Predictor(SimpleTransformer.from_config(cfg, device=d, seed=SEED), device=d)
                for d in ("cuda", "cpu"))
    requests = [{k: b[k] for k in ("node", "pos", "grid")} for b in loader]
    serve_and_check(f"ex1 galerkin f32 nonuniform n={TRAIN_N} batch={BATCH}", gpu, cpu,
                    [requests[i % len(requests)] for i in range(REQUESTS)],
                    "galerkin_scores", cfg["num_encoder_layers"], BATCH * TRAIN_N,
                    (BATCH, TRAIN_N, 1), TOL_SERVE, replayed)
    print(f"ex1 variants: + nonuniform meshes {time.perf_counter() - t0:.1f} s")
    masks_phase(rng)

    print(f"ex1 variants phase: {time.perf_counter() - t0:.1f} s")
    counts = Counter(launches())
    counts.update(forward_launches(replayed))
    counts.update(runner_launches(runners))
    return {name: counts[name] for name in COUNTERS}


# generators phase: the multigrid Darcy solve at the 421 grid (levels 421, 211,
# 106), first at a fixed count on a few fields, card against CPU: float32 sums
# in another order through two cycles, each with 318 coarse CG iterations
GEN_GRID = 421
GEN_FIXED_SAMPLES = 4
GEN_FIXED_CYCLES = 2
TOL_GEN_FIXED = 1e-4       # of the CPU solution's largest entry
GEN_SAMPLES = 16           # the full solve through the residual gate
GEN_GATE = 0.05
COLE_HOPF_N = 8192
COLE_HOPF_SAMPLES = 8
TOL_COLE_HOPF = 1e-4       # of max|u| on the CPU: exp(-U/2ν) at ν = 0.01 in float32


def generators_phase():
    """The device-side generators on the card (``data/synthetic_torch.py``):
    the multigrid Darcy solve of the same coefficient fields on the card and
    on the CPU at a fixed count (`GEN_FIXED_CYCLES` cycles, tol 0), and the
    card's captured cycles bit-equal to its eager ones; the full solve of
    `GEN_SAMPLES` fields at 421² through the residual gate, every sample below
    0.05 (float32 on the device, float64 on the host), eager and captured,
    with the kernels of one cycle and the seconds per sample of each;
    Cole–Hopf Burgers at n = 8192, card against CPU.  No kernel of the port
    runs here.  Returns the launch counts of its run (none)."""
    reset_launches()
    t0 = time.perf_counter()
    re, im = ST.grf_2d_normals(torch.Generator().manual_seed(SEED), GEN_FIXED_SAMPLES, GEN_GRID)
    g = ST.grf_2d_from_normals(re, im, tau=3.0, alpha=2.0, device="cuda")
    coeff = torch.where(g >= 0, 12.0, 3.0).float()
    fixed = dict(max_cycles=GEN_FIXED_CYCLES, tol=0.0)
    run = {}
    gpu = ST.darcy_mg(coeff, GEN_GRID, stats=run, **fixed)
    eager = ST.darcy_mg(coeff, GEN_GRID, graphs=False, **fixed)
    cpu = ST.darcy_mg(coeff.cpu(), GEN_GRID, **fixed)
    err = float((gpu.cpu() - cpu).abs().max() / cpu.abs().max())
    same = torch.equal(gpu, eager)
    print(f"generators: darcy_mg at {GEN_GRID}^2 (levels {ST.mg_sizes(GEN_GRID)}), "
          f"{GEN_FIXED_SAMPLES} fields, {GEN_FIXED_CYCLES} cycles at tol 0: card vs CPU "
          f"{err:.3e} of max|cpu| (tol {TOL_GEN_FIXED:.0e}); captured cycles "
          f"{'bit-equal' if same else 'NOT bit-equal'} to eager ones on the card; "
          f"{run['kernels']} device kernels a captured cycle")
    if not (err <= TOL_GEN_FIXED and same and run["cycles"] == GEN_FIXED_CYCLES):
        raise AssertionError("generators: the multigrid solve disagrees")
    rates = {}
    for graphs in (False, True):
        st = {}
        torch.cuda.synchronize()
        coeff_np, sol = ST.darcy_mg_torch(GEN_SAMPLES, GEN_GRID, seed=SEED, batch=GEN_SAMPLES,
                                          graphs=graphs, stats=st)
        mode = "captured" if graphs else "eager"
        rates[mode] = st["seconds"] / GEN_SAMPLES
        print(f"generators: darcy_mg_torch {GEN_SAMPLES} samples at {GEN_GRID}^2 ({mode} "
              f"cycles): {st['seconds']:.3f} s with the fields and the gate, "
              f"{rates[mode] * 1e3:.2f} ms a sample, {GEN_SAMPLES / st['seconds']:.1f} "
              f"samples/s; {st['cycles']} cycles; f32 residual gate max {st['gate_max']:.3e}, "
              f"f64 max {st['f64_max']:.3e} (gate {GEN_GATE}); {st['resolved']} re-solved by "
              f"CG; {st['kernels_per_cycle']} kernels a captured cycle")
        res64 = ST.fd_residual_host(coeff_np, sol)
        if not (res64.max() < GEN_GATE and st["gate_max"] < GEN_GATE and np.isfinite(sol).all()
                and sol.shape == (GEN_SAMPLES, GEN_GRID, GEN_GRID)):
            raise AssertionError(f"generators: a sample above the gate ({res64.max():.3e})")
    print(f"generators: multigrid {rates['eager'] / rates['captured']:.2f}x faster a sample "
          f"with captured cycles ({rates['eager'] * 1e3:.2f} -> {rates['captured'] * 1e3:.2f} "
          f"ms)")
    a = ST.grf_1d_torch(torch.Generator().manual_seed(SEED), COLE_HOPF_SAMPLES, COLE_HOPF_N,
                        device="cuda")
    u_gpu = ST.cole_hopf_torch(a, 0.01, 1.0)
    u_cpu = ST.cole_hopf_torch(a.cpu(), 0.01, 1.0)
    err = float((u_gpu.cpu() - u_cpu).abs().max() / u_cpu.abs().max())
    print(f"generators: Cole-Hopf Burgers at n={COLE_HOPF_N}, {COLE_HOPF_SAMPLES} fields: card "
          f"vs CPU {err:.3e} of max|u| (tol {TOL_COLE_HOPF:.0e}); phase "
          f"{time.perf_counter() - t0:.1f} s")
    if not err <= TOL_COLE_HOPF:
        raise AssertionError("generators: Cole-Hopf disagrees")
    return {name: launches()[name] for name in COUNTERS}


# the ex2 driver at its own grid: the data made by multigrid on the card, the
# full-width model trained at the defaults' (n_f, n_c) = (141, 43)
DARCY_421_SAMPLES = 32
# what a phase leaves for a later one: `darcy_421_phase`'s checkpoint for `eval_phase`
KEPT = {}


def darcy_421_phase():
    """``examples/ex2_darcy.py`` at its defaults (``--n-grid-fine 421``,
    subsample 3 and 10) on `DARCY_421_SAMPLES` training samples for one
    epoch, with the data made afresh by ``darcy_mg_torch`` on the card: the
    training and validation sets both from the device branch, each train
    step's graph exactly 6 ``galerkin_scores`` and 6 ``galerkin_scores_bwd``
    and each eval step's 6 ``galerkin_scores``; keeps a copy of its
    checkpoint for `eval_phase`.  Returns the launch counts of its run, the
    graph replays included."""
    reset_launches()
    t0 = time.perf_counter()
    with runner_hooks() as runners, tempfile.TemporaryDirectory() as tmp, fresh_data_dir():
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            val = ex2_darcy.main(["--n-samples", str(DARCY_421_SAMPLES), "--epochs", "1"],
                                 model_save_path=tmp)
        print(printed.getvalue(), end="")
        ckpt = _driver_outputs("ex2 421", tmp, val, 1)
        keep = tempfile.mkdtemp()
        KEPT["ex2_421"] = (shutil.copy(ckpt, keep), val)   # for eval_phase, which removes it
    made = printed.getvalue().count("Darcy samples at 421² (device MG")
    if made != 2 or len(runners) != 1 or runners[0].replays == 0:
        raise AssertionError(f"ex2 421: {made} sets from the device generator, "
                             f"{len(runners)} device loops")
    (train_k, train_r), (eval_k, eval_r) = runners[0].replayed()
    if (dict(wrapper_launches(train_k)) != {"galerkin_scores": 6, "galerkin_scores_bwd": 6}
            or dict(wrapper_launches(eval_k)) != {"galerkin_scores": 6}):
        raise AssertionError(f"ex2 421: graphs hold {wrapper_launches(train_k)} and "
                             f"{wrapper_launches(eval_k)}")
    counts = Counter(launches())
    counts.update(runner_launches(runners))
    print(f"driver ex2 at the 421 grid (data by multigrid on the card, f32, (n_f,n_c)=(141,43)):"
          f" 1 epoch, validation metric {val:.4e}; train graph 6+6 galerkin kernels "
          f"({train_r} replays), eval graph 6 ({eval_r} replays); launches {dict(counts)}; "
          f"{time.perf_counter() - t0:.1f} s")
    return {name: counts[name] for name in COUNTERS}


# graph phase: the ex1 model with a GCN or GAT lift at n = 1024 (subsample 8;
# BurgersDataset's edge features: two Krylov powers and two distance
# channels), and the ex2 model with a GCN extractor at (141, 43) on the coarse
# grid's FEM features (three Krylov powers of the normalized Laplacian);
# galerkin attention throughout.  The 2D edge encoder convolves n_c² × n_c²
# images (1849² at (141, 43)): the CPU's forward of one sample takes ~15 s
# on 8 threads, so the (141, 43) model is served against the CPU at batch 1
# and stepped on the card alone, and its step is held against the CPU at
# (61, 13)
GRAPH_SUBSAMPLE = 8
GRAPH_BATCH = 2
GRAPH_2D = dict(n_grid_fine=421, subsample_nodes=3, subsample_attn=10, n_samples_synthetic=8,
                train_len=6, return_edge=True)
GRAPH_2D_STEP = dict(n_grid_fine=61, subsample_nodes=1, subsample_attn=5, n_samples_synthetic=8,
                     train_len=6, return_edge=True)
GRAPH_2D_STEPS = 5   # timed card steps at (141, 43)


def graph_phase():
    """Graph features on the card (``models/graph.py``): a GCN and a GAT
    `SimpleTransformer` at the ex1 width (d = 96, galerkin) at n = 1024,
    each served through `Predictor` (edge features passed) against the CPU
    as in item 5, with exactly its galerkin launches in the graph, and one
    train step (dropout off) against the CPU; a GCN `FourierTransformer2D`
    at the ex2 width at (n_f, n_c) = (141, 43) with its edge features from
    `DarcyDataset` (data by multigrid on the card) served against the CPU
    and stepped and timed on the card (its launches exact), and its step
    against the CPU at (61, 13) (`spread_step`).  Returns the launch counts
    of its run, the graph replays included."""
    reset_launches()
    t0 = time.perf_counter()
    replayed = []
    train = BurgersDataset(subsample=GRAPH_SUBSAMPLE, train_data=True, train_portion=0.5,
                           n_samples_synthetic=TRAIN_SAMPLES, return_edge=True)
    n = train.n_grid
    batches = [b for b, _ in zip(DataLoader(train, GRAPH_BATCH), range(3))]
    edge_feats = batches[0]["edge"].shape[-1]
    h = 1 / n
    for kind in ("gcn", "gat"):
        cfg = {**load_config("ex1_burgers"), "attention_type": "galerkin",
               "feat_extract_type": kind, "num_feat_layers": 2, "edge_feats": edge_feats}
        gpu = Predictor(SimpleTransformer.from_config(cfg, seed=SEED))
        cpu = Predictor(SimpleTransformer.from_config(cfg, device="cpu", seed=SEED), device="cpu")
        same_weights(gpu, cpu)
        tag = f"ex1 {kind} galerkin f32 n={n} batch={GRAPH_BATCH} edge_feats={edge_feats}"
        serve_and_check(tag, gpu, cpu, batches, "galerkin_scores", cfg["num_encoder_layers"],
                        GRAPH_BATCH * n, (GRAPH_BATCH, n, 1), TOL_SERVE, replayed)
        del gpu, cpu
        steps, models = {}, {}
        for device in ("cuda", "cpu"):
            model = no_dropout(SimpleTransformer.from_config(cfg, device=device, seed=SEED))
            opt = AdamOneCycle(model.parameters(), 1e-3, 100, grad_clip=0.999)
            models[device] = model
            steps[device] = make_burgers_steps(
                model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1), WeightedL2Loss(h=h),
                opt)[0]
        compare_step(tag, steps, models, batches[0],
                     {"galerkin_scores": 4, "galerkin_scores_bwd": 4}, TOL_TRAIN_LOSS,
                     TOL_TRAIN_GRAD)
        del steps, models
        release_graphs()

    print(f"graph: the ex1 cases {time.perf_counter() - t0:.1f} s "
          f"({torch.get_num_threads()} CPU threads)")

    def graph_2d(spec, batch):
        data = DarcyDataset(train_data=True, **spec)
        n_f = (spec["n_grid_fine"] - 1) // spec["subsample_nodes"] + 1
        batches = [b for b, _ in zip(DataLoader(data, batch), range(3))]
        normalizer = data.normalizer_y.as_tuple()
        cfg = {**ex2_config(n_f, data.n_grid), "feat_extract_type": "gcn",
               "num_feat_layers": 2, "edge_feats": batches[0]["edge"].shape[-1]}
        print(f"graph: DarcyDataset with edge features at (n_f, n_c) = ({n_f}, {data.n_grid}) "
              f"({data.assembly} assembly), edge {batches[0]['edge'].shape}")
        return (n_f, data.n_grid), batches, normalizer, cfg

    (n_f, n_c), batches, normalizer, cfg = graph_2d(GRAPH_2D, 1)
    gpu = Predictor(FourierTransformer2D.from_config(cfg, seed=SEED), normalizer=normalizer)
    cpu = Predictor(FourierTransformer2D.from_config(cfg, device="cpu", seed=SEED),
                    normalizer=normalizer, device="cpu")
    same_weights(gpu, cpu)
    tag = f"ex2 gcn galerkin f32 (n_f,n_c)=({n_f},{n_c})"

    def variation(out):   # the encoder shows in what varies over the grid
        mean, std, eps = normalizer
        part = ((out - mean) / (std + eps))[:, 1:-1, 1:-1]
        return float(np.abs(part - part.mean()).max())

    serve_and_check(f"{tag} batch=1", gpu, cpu, batches, "galerkin_scores",
                    cfg["num_encoder_layers"], n_f * n_f, (1, n_f, n_f, 1), TOL_SERVE, replayed,
                    scale_of=variation)
    del gpu, cpu
    release_graphs()
    per_step = {"galerkin_scores": 6, "galerkin_scores_bwd": 6}
    _, step = ex2_step("cuda", None, cfg, batches, normalizer, n_f)
    before = launches()
    losses = [float(x) for x in step(batches[0])]
    moved = {k: launches()[k] - before[k] for k in before if launches()[k] != before[k]}
    if moved != per_step or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train {tag}: launches {moved}, losses {losses}")
    time_steps(f"{tag} batch=1 (card only)", step, batches, GRAPH_2D_STEPS, n_f * n_f)
    del step
    release_graphs()
    (n_f, n_c), batches, normalizer, cfg = graph_2d(GRAPH_2D_STEP, GRAPH_BATCH)
    spread_step(f"ex2 gcn galerkin f32 (n_f,n_c)=({n_f},{n_c}) batch={GRAPH_BATCH}",
                lambda device: ex2_step(device, None, {**cfg, **NO_DROPOUT}, batches,
                                        normalizer, n_f), batches[0], per_step)
    counts = Counter(launches())
    counts.update(forward_launches(replayed))
    print(f"graph phase: {time.perf_counter() - t0:.1f} s")
    return {name: counts[name] for name in COUNTERS}


# the 2D GCN step's float32 gradients carry rounding far beyond
# TOL_TRAIN_GRAD: behind the GCN's aggregation the features vary little over
# the nodes, and the attention's per-head LN (eps 1e-7 below n_f = 211)
# divides by their spread; on the CPU two runs of the (61, 13) step differ by
# 2-3 % of the gradient's norm and up to 28 % of a tensor's scale (the
# plain model's by 2e-7).  So the card is held to the CPU within
# SPREAD_FACTOR times the CPU's own spread, tensor by tensor
SPREAD_FACTOR = 4.0


def spread_step(tag, make, batch, per_step):
    """One train step from the same weights on the card and three times on
    the CPU (its default thread count twice, then one thread); `make(device)`
    -> (model, step).  The card's step launches exactly `per_step`; its
    losses agree with the CPU's to `TOL_TRAIN_LOSS`; each gradient is within
    `SPREAD_FACTOR` times the CPU runs' largest gap, or within
    `TOL_TRAIN_GRAD`, of max(its largest entry, `GRAD_FLOOR` of the model's
    largest gradient)."""
    runs = {}
    for run in ("cuda", "cpu", "cpu again", "cpu, 1 thread"):
        threads = torch.get_num_threads()
        if run == "cpu, 1 thread":
            torch.set_num_threads(1)
        try:
            model, step = make("cuda" if run == "cuda" else "cpu")
            before = launches()
            losses = [float(x) for x in step(batch)]
            moved = {k: launches()[k] - before[k] for k in before if launches()[k] != before[k]}
            runs[run] = losses, {k: p.grad.detach().cpu() for k, p in model.named_parameters()}
        finally:
            torch.set_num_threads(threads)
        if run == "cuda" and moved != per_step:
            raise AssertionError(f"train {tag}: launched {moved}, expected {per_step}")
    (got, card), (want, cpu) = runs["cuda"], runs["cpu"]
    others = [runs["cpu again"][1], runs["cpu, 1 thread"][1]]
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, want) if b != 0)
    top = max(float(g.abs().max()) for g in cpu.values())
    worst, worst_key, spread = 0.0, "", 0.0
    for key, ref in cpu.items():
        scale = max(float(ref.abs().max()), GRAD_FLOOR * top)
        gap = float((card[key] - ref).abs().max()) / scale
        own = max(float((other[key] - ref).abs().max()) for other in others) / scale
        spread = max(spread, own)
        allowed = max(SPREAD_FACTOR * own, TOL_TRAIN_GRAD)
        if gap / allowed > worst:
            worst, worst_key = gap / allowed, key
    print(f"train {tag}: losses {got} vs CPU {want} (max rel err {loss_err:.3e}, tol "
          f"{TOL_TRAIN_LOSS:.1e}); the CPU's runs differ by up to {spread:.3e} of a "
          f"gradient's scale; the card's worst gradient at {worst:.3f} of its allowance "
          f"(max({SPREAD_FACTOR:g}x the CPU's spread, {TOL_TRAIN_GRAD:.0e})) at {worst_key}; "
          f"launches/step {per_step}")
    if not (all(math.isfinite(x) for x in got) and loss_err <= TOL_TRAIN_LOSS and worst <= 1):
        raise AssertionError(f"train {tag}: the card's step is off the CPU's")


RF_LOOP_EPOCHS = 4   # 4 steps an epoch: 2 eager, 14 replays


def random_features_phase():
    """Random-feature attention on the card (``models/random_fourier.py``):
    the ex1-width `RandomFourierTransformer` (favor, then rfa) trained
    through `DeviceEpochRunner` against the eager host loop as in item 7,
    each step's ω redrawn on the host before it (``before_step``): the ω
    of every replay must differ from the one before, and the captured run's
    sequence of ω must equal the eager loop's.  No kernel of the port runs
    here.  Returns the launch counts of its run (none)."""
    reset_launches()
    train = ex1_train_data()
    runners = []
    for kind in ("favor", "rfa"):
        drawn = []   # each make()'s ω sequence: the captured run, the eager run, the timed run

        def make(device, kind=kind):
            model = no_dropout(ex1_burgers_random_fourier_features.RandomFourierTransformer(
                attention_type=kind, device=device, seed=SEED))
            opt = AdamOneCycle(model.parameters(), 1e-3, 100 * (TRAIN_SAMPLES // 2 // BATCH))
            h = 1 / TRAIN_N
            train_step, eval_step = make_burgers_steps(
                model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1), WeightedL2Loss(h=h),
                opt)
            gen, seen = torch.Generator().manual_seed(SEED), []
            drawn.append(seen)

            def before():
                redraw_random_features(model, gen)
                seen.append(model.encoder_layers[0].attn.omega.detach().cpu().clone())

            train_step.before_step = before
            return model, opt, train_step, eval_step

        tag = f"ex1 random features {kind} f32 n={TRAIN_N} batch={BATCH}"
        runners.extend(loop_case(tag, make, train, BATCH, {}, RF_LOOP_EPOCHS, TOL_LOOP,
                                 TOL_LOOP, BATCH * TRAIN_N))
        captured, eager = drawn[0], drawn[1]
        same = len(captured) == len(eager) and all(torch.equal(a, b)
                                                    for a, b in zip(captured, eager))
        fresh = all(not torch.equal(a, b) for a, b in zip(captured, captured[1:]))
        print(f"random features {kind}: {len(captured)} steps, each with a new ω "
              f"({'every one differs from the one before' if fresh else 'REPEATED'}); the "
              f"captured run's ω sequence {'equals' if same else 'DIFFERS FROM'} the eager "
              f"loop's")
        if not (same and fresh):
            raise AssertionError(f"random features {kind}: ω not redrawn per replay")
    counts = Counter(launches())
    counts.update(runner_launches(runners))
    return {name: counts[name] for name in COUNTERS}


def release_graphs():
    """Free what earlier work left on the card: a Predictor and its captured
    requests refer to each other, so their graphs (and the memory pools they
    hold) go only when the cycle collector runs."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# the 2D model's other attention types (``FourierTransformer2D`` at the ex2
# width): served at the first grid pair and trained for a step against the CPU
# and in the device loop; float32 for all five, bfloat16 for the
# SimpleAttention types JAX's bf16 path computes in plain XLA
VARIANTS_2D = (("linear", None), ("global", None), ("softmax", None), ("cosine", None),
               ("official", None), ("linear", torch.bfloat16), ("softmax", torch.bfloat16),
               ("cosine", torch.bfloat16))
VARIANTS_2D_REQUESTS = 3
VARIANTS_2D_LOOP_EPOCHS = 4   # 2 steps an epoch: 2 eager, 6 replays


def variants_2d_phase(rng):
    """The rest of the 2D model on the card (ex2 width, random weights):
    each type of `VARIANTS_2D` served through `Predictor` against the CPU
    model of the same weights (no kernel in its graph), one train step
    (dropout off) against the CPU and the step through `DeviceEpochRunner`
    against the eager host loop (no kernel in its graph); galerkin and
    fourier (f32) with ``return_attn_weight`` and ``return_latent``, whose
    requests must equal the plain model's and launch its kernels exactly;
    ``causal`` raising as on the CPU (the 2D model passes no mask).
    Each type's graphs are counted and freed before the next type's (a 2D
    request's graph holds ~0.9 GiB).  Returns the launch counts of its
    run."""
    reset_launches()
    t0 = time.perf_counter()
    replayed, runners, counts = [], [], Counter()

    def count_and_free():
        counts.update(forward_launches(replayed))
        counts.update(runner_launches(runners))
        replayed.clear()
        runners.clear()
        release_graphs()

    n_f, n_c = GRIDS_2D[0]
    cfg = ex2_config(n_f, n_c)
    n_layers = cfg["num_encoder_layers"]
    normalizer = ((0.1 * rng.standard_normal((n_f, n_f, 1))).astype(np.float32),
                  rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32), np.float32(1e-5))
    pos, grid = darcy_grids(n_f, n_c)
    batches = [dict(node=rng.standard_normal((BATCH_2D, n_f, n_f, 1)).astype(np.float32),
                    pos=pos[None].repeat(BATCH_2D, 0), grid=grid[None].repeat(BATCH_2D, 0))
               for _ in range(VARIANTS_2D_REQUESTS)]

    def model_part(out):
        """The interior with the normalizer undone: what the model computes."""
        mean, std, eps = normalizer
        return ((out - mean) / (std + eps))[:, 1:-1, 1:-1]

    def variation(out):   # as in serving_2d_phase: the encoder shows in what varies
        part = model_part(out)
        return float(np.abs(part - part.mean()).max())

    def largest(out):
        return float(np.abs(model_part(out)).max())

    def predictors(config, dtype, ref_dtype):
        gpu = Predictor(FourierTransformer2D.from_config(config, seed=SEED, dtype=dtype),
                        normalizer=normalizer)
        cpu = Predictor(FourierTransformer2D.from_config(config, device="cpu", seed=SEED,
                                                         dtype=ref_dtype),
                        normalizer=normalizer, device="cpu")
        same_weights(gpu, cpu)
        return gpu, cpu

    shape, points = (BATCH_2D, n_f, n_f, 1), BATCH_2D * n_f * n_f
    for atype, dtype in VARIANTS_2D:
        tol, ref_dtype = (TOL_SERVE, None) if dtype is None else (TOL_SERVE_BF16, dtype)
        if dtype is not None and atype == "cosine":   # against float32, as in ex1
            tol, ref_dtype = TOL_SERVE_COSINE_BF16_2D, None
        gpu, cpu = predictors({**cfg, "attention_type": atype}, dtype, ref_dtype)
        serve_and_check(f"ex2 {atype} {dtype_name(dtype)} (n_f,n_c)=({n_f},{n_c}) "
                        f"batch={BATCH_2D}", gpu, cpu, batches, None, 0, points, shape, tol,
                        replayed, scale_of=variation if dtype is None else largest)
        del gpu, cpu
        count_and_free()
    for atype, kernel in (("galerkin", "galerkin_scores"), ("fourier", "fourier_chain")):
        plain, _ = predictors({**cfg, "attention_type": atype}, None, None)
        gpu, cpu = predictors({**cfg, "attention_type": atype, "return_attn_weight": True,
                               "return_latent": True}, None, None)
        tag = (f"ex2 {atype} f32 return_attn_weight+return_latent (n_f,n_c)=({n_f},{n_c}) "
               f"batch={BATCH_2D}")
        got = serve_and_check(tag, gpu, cpu, batches, kernel, n_layers, points, shape,
                              TOL_SERVE, replayed, scale_of=variation)
        want = plain.warmup(batches[0])(batches[0])
        replayed.append(plain.captured(batches[0]))
        if dict(wrapper_launches(plain.captured(batches[0]).kernels())) != {kernel: n_layers}:
            raise AssertionError(f"{tag}: the plain request launches other kernels")
        gap = float(np.abs(got - want).max())
        print(f"  {tag}: preds vs the plain model's request max_abs_err={gap:.3e} "
              f"({'bit-equal' if gap == 0 else 'not bit-equal'}), both {n_layers} {kernel} "
              f"a request")
        if gap > TOL_SERVE * variation(want):
            raise AssertionError(f"{tag}: returning weights and latents moved the preds")
        del plain, gpu, cpu
        count_and_free()
    causal = {**cfg, "attention_type": "causal"}
    for device in ("cuda", "cpu"):
        pred = Predictor(FourierTransformer2D.from_config(causal, device=device, seed=SEED),
                         device=device)
        try:
            pred(batches[0])
        except ValueError as e:
            if "mask" not in str(e):
                raise
            print(f"ex2 causal on the {device}: raises as in JAX ({e})")
        else:
            raise AssertionError(f"ex2 causal on the {device}: served without a mask")
    print(f"2D variants: serving {time.perf_counter() - t0:.1f} s")

    train_2d, tbatches, tnormalizer, (tn_f, tn_c) = ex2_train_data()
    tcfg = {**ex2_config(tn_f, tn_c), **NO_DROPOUT}
    for atype, dtype in VARIANTS_2D:
        config = {**tcfg, "attention_type": atype}

        def make(device, dtype=dtype, config=config):
            model, opt, train_step, eval_step = ex2_step(device, dtype, config, tbatches,
                                                         tnormalizer, tn_f, steps=True)
            return no_dropout(model), opt, train_step, eval_step

        steps, models = {}, {}
        for device in ("cuda", "cpu"):
            models[device], _, steps[device], _ = make(device)
        tag = f"ex2 {atype} {dtype_name(dtype)} (n_f,n_c)=({tn_f},{tn_c}) batch={BATCH_2D}"
        compare_step(tag, steps, models, tbatches[0], {},
                     TOL_TRAIN_LOSS if dtype is None else TOL_TRAIN_LOSS_BF16,
                     TOL_TRAIN_GRAD if dtype is None else TOL_TRAIN_GRAD_BF16, GRAD_FLOOR)
        del steps, models
        runners.extend(loop_case(tag, make, train_2d, BATCH_2D, {}, VARIANTS_2D_LOOP_EPOCHS,
                                 TOL_LOOP if dtype is None else TOL_TRAIN_LOSS_BF16,
                                 TOL_LOOP if dtype is None else TOL_TRAIN_GRAD_BF16,
                                 BATCH_2D * tn_f * tn_f))
        count_and_free()
    print(f"2D variants phase: {time.perf_counter() - t0:.1f} s")
    counts.update(launches())
    return {name: counts[name] for name in COUNTERS}


# the reference's galerkin SimpleTransformer after 500 epochs
# (eval/calibrate_reference_burgers.py, seed 1127802, subsample 4, 1074
# training and 100 validation fields of 2148), the last entry of its
# history_clean (the validation metric with its always-on score dropout off),
# and how close the port's reading on the card must come to it
ANCHOR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "eval",
                      "torch_anchor_500ep.ckpt")
ANCHOR_METRIC = 1.4932e-3
ANCHOR_SAMPLES = 2148
ANCHOR_VAL_BATCH = 16   # the calibration's validation loader
TOL_ANCHOR = 1e-2       # relative


def checkpoints_phase():
    """The reference's checkpoint through `Predictor.from_checkpoint` on the
    card: its validation metric (the calibration's metric, the mean over
    batches of 16 of each batch's mean relative L2) on the calibration's
    100 validation fields, against the reference's own reading; its graphs
    must launch ``galerkin_scores`` in every encoder layer.  (The port's
    driver checkpoint goes round the three loaders in `driver_phase`.)
    Returns the launch counts of its run."""
    reset_launches()
    t0 = time.perf_counter()
    cfg = {**load_config("ex1_burgers"), "attention_type": "galerkin"}
    pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, seed=SEED), ANCHOR)
    kind = read_checkpoint(ANCHOR)[0]
    valid = BurgersDataset(subsample=SUBSAMPLE, train_data=False, valid_portion=100,
                           n_samples_synthetic=ANCHOR_SAMPLES)
    metric_fn = WeightedL2Loss(regularizer=False, h=1 / valid.n_grid)
    metrics, shapes = [], {}
    for batch in DataLoader(valid, ANCHOR_VAL_BATCH):
        preds = torch.from_numpy(pred(batch))
        metrics.append(float(metric_fn(preds[..., 0],
                                       torch.from_numpy(batch["target"][..., 0])).metric))
        shapes[batch["node"].shape] = batch
    forwards = [pred.captured(b) for b in shapes.values()]
    for forward in forwards:
        got = dict(wrapper_launches(forward.kernels()))
        if got != {"galerkin_scores": cfg["num_encoder_layers"]}:
            raise AssertionError(f"reference checkpoint: a request holds {got}")
    val = float(np.mean(metrics))
    rel = abs(val - ANCHOR_METRIC) / ANCHOR_METRIC
    print(f"reference checkpoint ({kind}, {os.path.basename(ANCHOR)}) served on the card: "
          f"validation metric {val:.6e} on {len(valid)} fields at n={valid.n_grid} "
          f"({len(metrics)} batches of {ANCHOR_VAL_BATCH}, {len(forwards)} request shapes) vs "
          f"the reference's {ANCHOR_METRIC:.4e}: rel gap {rel:.3e} (tol {TOL_ANCHOR:.0e}); "
          f"{cfg['num_encoder_layers']} galerkin_scores a request; "
          f"{time.perf_counter() - t0:.1f} s")
    if not rel <= TOL_ANCHOR:
        raise AssertionError("reference checkpoint: the validation metric is off the "
                             "reference's")
    counts = Counter(launches())
    counts.update(forward_launches(forwards))
    return {name: counts[name] for name in COUNTERS}


def round_trip(ckpt, cfg, batch, want, served):
    """The port's checkpoint `ckpt` of the ex1 model of `cfg` written again
    as the JAX package's checkpoint, as the original torch implementation's
    and as the port's own, each read back by `Predictor.from_checkpoint`
    (which tells the kind by content) into a fresh model: every request
    equal to `want` bit for bit."""
    params = load_checkpoint(ckpt)["params"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"jax": os.path.join(tmp, "as_jax.ckpt"),
                 "reference": os.path.join(tmp, "as_reference.pt"),
                 "port": os.path.join(tmp, "as_port.ckpt")}
        save_jax_checkpoint(paths["jax"], params, n_head=cfg["n_head"])
        torch.save({"model": params, "epochs_done": 2}, paths["reference"])
        save_checkpoint(paths["port"], params)
        for kind, path in paths.items():
            if read_checkpoint(path)[0] != kind:
                raise AssertionError(f"round trip: {path} read as {read_checkpoint(path)[0]}")
            pred = Predictor.from_checkpoint(SimpleTransformer.from_config(cfg, seed=7), path)
            outs = [pred(batch) for _ in range(2)]   # eager and capture, then a replay
            served.append(pred.captured(batch))
            if not all(np.array_equal(o, want) for o in outs):
                raise AssertionError(f"round trip through the {kind} loader: the requests "
                                     f"differ from the port checkpoint's")
    print(f"driver ex1 checkpoint: written as a JAX, a reference and a port checkpoint and "
          f"read back by content, each served bit-equal to the original")


# decoder phase: one GalerkinTransformerDecoderLayer at the ex1 width (d 96,
# 1 head, pos of one column, FFN 192) at n = 8192, batch 8, with per-head
# LN in both attentions (layer_norm off), dropout 0; its forward and one
# backward per attention type, with exactly these launches
DECODER = dict(d_model=96, nhead=1, pos_dim=1, dim_feedforward=192, layer_norm=False,
               dropout=0.0)
DECODER_LAUNCHES = {"galerkin": ({"galerkin_scores": 1}, {"galerkin_scores_bwd": 1}),
                    "fourier": ({"fourier_chain": 1}, {"fourier_chain": 3})}


def decoder_phase(rng, n=RESOLUTIONS[0]):
    """`GalerkinTransformerDecoderLayer` at the ex1 width on the card against
    the same weights on the CPU, for galerkin and fourier self-attention:
    a forward (exactly one ``galerkin_scores`` or ``fourier_chain``) on
    the rows whose cross-attention keeps its float32 accuracy (κ_t <=
    CAUSAL_KAPPA in every head) to TOL_SERVE, its cross-attention against
    float64 on those rows (`causal_witness`), and one step (exactly one
    ``galerkin_scores_bwd`` or three ``fourier_chain`` more) on the loss
    Σ out² over those rows against the CPU; the forward and the step
    timed.  Returns the launch counts."""
    reset_launches()
    t0 = time.perf_counter()
    x, memory = (torch.from_numpy(rng.standard_normal((BATCH, n, 96)).astype(np.float32))
                 for _ in range(2))
    pos = torch.linspace(0, 1, n)[None, :, None].expand(BATCH, n, 1).contiguous()
    for atype, (fwd, bwd) in DECODER_LAUNCHES.items():
        cpu = GalerkinTransformerDecoderLayer(
            **DECODER, attention_type=atype,
            generator=torch.Generator().manual_seed(SEED)).eval()
        gpu = copy.deepcopy(cpu).cuda()
        xs, ms, ps = (t.cuda() for t in (x, memory, pos))
        seen = {}
        hook = gpu.cross_attn.register_forward_pre_hook(
            lambda mod, args, kwargs: seen.update(x1=args[0]), with_kwargs=True)
        before = launches()
        with torch.no_grad():
            out = gpu(xs, ms, ps)
        torch.cuda.synchronize()
        hook.remove()
        got = Counter(launches()) - Counter(before)
        if dict(got) != fwd:
            raise AssertionError(f"decoder {atype}: a forward launched {dict(got)}, "
                                 f"expected {fwd}")
        kappa, wit = causal_witness(f"decoder {atype} cross-attention", gpu.cross_attn,
                                    seen["x1"], memory, pos, torch.ones(BATCH, n))
        well = kappa <= CAUSAL_KAPPA
        with torch.no_grad():
            ref = cpu(x, memory, pos)
        out = out.cpu()
        err = float((out - ref).abs()[well].max())
        scale = float(ref[well].abs().max())
        with torch.no_grad():
            fwd_ms = time_ms(lambda: gpu(xs, ms, ps), 5)
        with torch.no_grad():
            print(f"  breakdown decoder {atype} forward: {breakdown(lambda: gpu(xs, ms, ps))}")
        print(f"decoder {atype} (d=96, 1 head, n={n}, batch={BATCH}, per-head LN): forward "
              f"{fwd_ms:.3f} ms, launches {fwd}; on the {100 * well.double().mean():.1f} % of "
              f"rows with κ <= {CAUSAL_KAPPA:.0e}: card vs CPU max_abs_err={err:.3e} "
              f"scale={scale:.3e} tol={TOL_SERVE:.1e}; cross-attention vs float64 on them: "
              f"card {wit['card']:.3e}, CPU {wit['CPU']:.3e} (tol {TOL_SERVE:.1e})")
        # at this n few rows are well conditioned (PERF.md §6, the decoder): at least
        # 1 % of them, so that the check holds something
        if not (torch.isfinite(out).all() and err <= TOL_SERVE * scale
                and well.sum() >= well.numel() // 100):
            raise AssertionError(f"decoder {atype}: the card and the CPU disagree")
        weight = well[..., None].float()

        def step_of(layer, dev):
            inputs = [t.to(dev) for t in (x, memory, pos, weight)]

            def step(_batch):
                layer.zero_grad(set_to_none=True)
                out = layer(*inputs[:3])
                loss = (inputs[3] * out ** 2).sum() / (inputs[3].sum() * out.shape[-1])
                loss.backward()
                return [loss.detach()]
            return step

        gpu.train(), cpu.train()
        steps = {"cuda": step_of(gpu, "cuda"), "cpu": step_of(cpu, "cpu")}
        compare_step(f"decoder {atype}", steps, {"cuda": gpu, "cpu": cpu}, None,
                     dict(Counter(fwd) + Counter(bwd)), TOL_TRAIN_LOSS, TOL_TRAIN_GRAD,
                     floor=GRAD_FLOOR)
        step_ms = time_ms(lambda: steps["cuda"](None), 3)
        print(f"  decoder {atype} step (forward and backward) {step_ms:.3f} ms")
        del gpu, steps
        release_graphs()
    print(f"decoder phase: {time.perf_counter() - t0:.1f} s")
    return launches()


# profiles phase: the four memory-profile drivers at their defaults.  The
# encoder profile's softmax type keeps B·H·n² float32 probabilities a layer;
# its step may reckon to peak (eagerly) at this share of the card's memory:
# `measure` also captures the step in a CUDA graph, whose private pool needs
# more than the eager peak (the first capture of the batch-8 step, 57.65 GiB
# eager, ran out of the card's 79.18 GiB with 14.24 GiB of it reserved but
# unallocated, PERF.md §6, the profiles)
PROFILE_DRIVERS = (("ex1", ex1_memory_profile, 4), ("ex2", ex2_memory_profile, 6),
                   ("ex3", ex3_memory_profile, 6), ("encoder", encoder_memory_profile, None))
MEMORY_MARGIN = 0.5
PROFILE_PER_LAYER = {"galerkin": {"galerkin_scores": 1, "galerkin_scores_bwd": 1},
                     "fourier": {"fourier_chain": 4}}
# the profiles' galerkin and fourier gradient steps at batch 1, card vs CPU:
# each gradient to TOL_PROFILE_GRAD of its largest entry, or of
# PROFILE_GRAD_FLOOR times the model's largest gradient where that is more.
# Against the same steps in float64, so held (``--profile-float64`` on an
# H100, PERF.md §6), float32 reads at most 2.213e-3 on the card and 1.436e-3
# on the CPU, both at ex3 fourier: the chain's order, (A Bᵀ) C, which the
# CPU's plain version shares (the card's step with the plain attention reads
# 2.7e-6 there); every other step reads at most 5.5e-4 on the card and
# 7.3e-4 on the CPU.  The bound is the sum of the two largest x1.25, rounded
# up.  The kernel phases hold the kernels themselves, to 1e-4 of their plain
# versions and 1e-5 of float64: the galerkin pair at the ex1, ex2 and encoder
# profiles' shapes, the chain at the ex1 and encoder ones
TOL_PROFILE_GRAD = 5e-3
PROFILE_GRAD_FLOOR = 1e-1


def profile_grads(tag, module, atype, args, cpu_step):
    """The profile's gradient step `module.make_step(atype, args)` on the
    card from the weights of the CPU's `cpu_step` (fn, params) on the same
    inputs: every gradient within TOL_PROFILE_GRAD of its largest entry, or of
    PROFILE_GRAD_FLOOR times the largest of all (`hold_grads`).  Returns
    the card step's launches."""
    fn, params = module.make_step(atype, args, torch.device("cuda"))
    cpu_fn, cpu_params = cpu_step
    with torch.no_grad():
        for p, q in zip(params, cpu_params, strict=True):
            p.copy_(q)
    before = launches()
    got = fn(params)
    torch.cuda.synchronize()
    ran = Counter(launches()) - Counter(before)
    want = cpu_fn(cpu_params)
    name = lambda i: f"#{i} {tuple(cpu_params[i].shape)}"
    grad_err, worst = hold_grads(tag, {name(i): g for i, g in enumerate(got)},
                                 {name(i): g for i, g in enumerate(want)}, TOL_PROFILE_GRAD,
                                 PROFILE_GRAD_FLOOR)
    print(f"  {tag}: card vs CPU at batch {args.batch_size}, {len(want)} gradients, max "
          f"err/max|g| {grad_err:.3e} at parameter {worst} (tol {TOL_PROFILE_GRAD:.1e}, floor "
          f"{PROFILE_GRAD_FLOOR:.0e} of the largest); launches {dict(ran)}")
    return ran


@contextlib.contextmanager
def plain_attention():
    """Inside the block the attention layers take their plain route (the
    route of heads wider than the kernels take), in the parameters' type."""
    saved = model_layers.GALERKIN_MAX_D, model_layers.FOURIER_MAX_D
    model_layers.GALERKIN_MAX_D = model_layers.FOURIER_MAX_D = 0
    try:
        yield
    finally:
        model_layers.GALERKIN_MAX_D, model_layers.FOURIER_MAX_D = saved


@contextlib.contextmanager
def float64_profile_steps():
    """Inside the block a profile driver's `make_step` builds its step in
    float64 (parameters and inputs), and the attention is plain."""
    holders = (ex1_memory_profile, ex2_memory_profile, encoder_memory_profile)
    tensors = [m.tensor for m in holders]
    for m in holders:
        m.tensor = lambda a, device: torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float64)).to(device)
    torch.set_default_dtype(torch.float64)
    try:
        with plain_attention():
            yield
    finally:
        torch.set_default_dtype(torch.float32)
        for m, t in zip(holders, tensors):
            m.tensor = t


def profile_float64_phase() -> list:
    """The readings behind PROFILE_GRAD_FLOOR: each profile's galerkin and
    fourier gradient step at batch 1 in float32 on the card (the kernels),
    on the card with the attention's plain route, and on the CPU, each
    against the same step in float64 on the card from the same weights:
    per step, the largest error of any gradient, of the model's largest
    gradient (``of_model``) and as `profile_grads` holds it (``held``: of
    its largest entry or PROFILE_GRAD_FLOOR of the model's largest, the
    larger), and the three largest errors of a gradient, of its largest
    entry (its size beside them, of the model's largest gradient)."""
    dev, cpu, rows = torch.device("cuda"), torch.device("cpu"), []

    def errors(got, ref):
        big = max(float(r.abs().max()) for r in ref)
        gaps = [float((g.double().cpu() - r.cpu()).abs().max()) for g, r in zip(got, ref)]
        out = sorted(((gap / float(r.abs().max()), i, float(r.abs().max()) / big)
                      for i, (gap, r) in enumerate(zip(gaps, ref))), reverse=True)
        held = max(gap / max(float(r.abs().max()), PROFILE_GRAD_FLOOR * big)
                   for gap, r in zip(gaps, ref))
        return dict(of_model=max(gaps) / big, held=held,
                    worst=[dict(err=e, param=i, size=m) for e, i, m in out[:3]])

    for tag, module, _ in PROFILE_DRIVERS:
        one = module.parser().parse_args(["--batch-size", "1"])
        for atype in PROFILE_PER_LAYER:
            cpu_fn, cpu_params = module.make_step(atype, one, cpu)
            fn, params = module.make_step(atype, one, dev)
            with float64_profile_steps():
                fn64, params64 = module.make_step(atype, one, dev)
            with torch.no_grad():
                for p, p64, q in zip(params, params64, cpu_params, strict=True):
                    p.copy_(q)
                    p64.copy_(q)
            kernel = [g.clone() for g in fn(params)]
            with float64_profile_steps():
                ref = fn64(params64)
                if any(g.dtype != torch.float64 for g in ref):
                    raise AssertionError(f"{tag} {atype}: the float64 step is not float64")
            with plain_attention():
                plain = fn(params)
            row = dict(profile=tag, type=atype, kernel=errors(kernel, ref),
                       card_plain=errors(plain, ref), cpu=errors(cpu_fn(cpu_params), ref))
            print(f"profile {tag} {atype} at batch 1 vs float64: {row}")
            rows.append(row)
            del fn, params, fn64, params64
            release_graphs()
    return rows


def profiles_phase(smi: str):
    """Each ``examples/*_memory_profile.py`` of the port at its defaults on
    the card (`compiled_cost` and `profile_step` per attention type, the
    table printed): each row keeps its captured step's graph, and the
    galerkin and fourier rows' graphs hold exactly one ``galerkin_scores``
    and one ``galerkin_scores_bwd``, or four ``fourier_chain``, per encoder
    layer, the others none; each row's FLOPs equal the CPU's count of the
    same step (the plain versions counted by FlopCounterMode), taken at
    batch 1 and times the batch (every count is linear in the batch,
    ``tests/test_torch_profiling.py``); the galerkin and fourier steps at
    batch 1 (the same shapes and kernels but the batch) give the CPU's
    gradients (`profile_grads`, launches not counted as the path's).  The
    encoder profile's softmax peak is reckoned first from its peak at
    batch 1; a batch that would pass MEMORY_MARGIN of the card's memory is
    cut to the largest that fits, and its line says so.  Returns the launch
    counts, the graphs' replays included."""
    reset_launches()
    t0 = time.perf_counter()
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    total = torch.cuda.get_device_properties(0).total_memory
    counts, tables = Counter(), {}
    for tag, module, layers in PROFILE_DRIVERS:
        t1 = time.perf_counter()
        parser = module.parser()
        args = parser.parse_args([])
        layers = layers or args.n_layers
        runs = [(list(args.attention_types), args.batch_size)]
        if tag == "encoder":
            fn, params = module.make_step("softmax", parser.parse_args(["--batch-size", "1"]),
                                          dev)
            peak1 = compiled_cost(fn, params)["temp_size_in_bytes"]
            del fn, params
            release_graphs()
            fits = int(MEMORY_MARGIN * total // peak1)
            print(f"profile encoder softmax: peak {peak1 / 2 ** 20:.1f} MiB at batch 1, "
                  f"reckoned {peak1 * args.batch_size / 2 ** 30:.2f} GiB at batch "
                  f"{args.batch_size} of the card's {total / 2 ** 30:.2f} GiB (margin "
                  f"{MEMORY_MARGIN}): {'fits' if fits >= args.batch_size else f'cut to batch {fits}'}")
            if fits < args.batch_size:
                runs = [([t for t in args.attention_types if t != "softmax"], args.batch_size),
                        (["softmax"], fits)]
        rows, batch_of = [], {}
        for types, bsz in runs:
            print(f"profile {tag}: {' '.join(types)} at batch {bsz} ({smi})")
            result = module.main(["--attention-types", *types, "--batch-size", str(bsz)])
            rows += result.rows
            batch_of.update(dict.fromkeys(types, bsz))
        counts.update(launches())
        names = [r["name"] for r in rows]
        if names != [t for types, _ in runs for t in types] or not all("graph" in r for r in rows):
            raise AssertionError(f"profile {tag}: rows {names}, expected one with its captured "
                                 f"graph per type run")
        one = parser.parse_args(["--batch-size", "1"])
        for row in rows:
            record = row["graph"]
            want = {k: v * layers for k, v in PROFILE_PER_LAYER.get(row["name"], {}).items()}
            graph = dict(wrapper_launches(record["kernels"]))
            if graph != want:
                raise AssertionError(f"profile {tag} {row['name']}: the captured step holds "
                                     f"{graph}, expected {want}")
            counts.update(graph_launches([(record["kernels"], record["replays"])]))
            cpu_step = module.make_step(row["name"], one, cpu)
            cpu_gflops = compiled_cost(*cpu_step)["flops"] * batch_of[row["name"]] / 1e9
            print(f"  {tag} {row['name']}: batch {batch_of[row['name']]}, {row['gflops']:.6f} "
                  f"GFLOPs on the card, {cpu_gflops:.6f} on the CPU (batch 1 × "
                  f"{batch_of[row['name']]}); {record['replays']} replays of a graph of "
                  f"{len(record['kernels'])} kernels, launches/step {want or 0}")
            if row["gflops"] != cpu_gflops:
                raise AssertionError(f"profile {tag} {row['name']}: FLOPs differ from the CPU's")
            if want:
                ran = profile_grads(f"profile {tag} {row['name']}", module, row["name"], one,
                                    cpu_step)
                if dict(ran) != want:
                    raise AssertionError(f"profile {tag} {row['name']}: the batch-1 step "
                                         f"launched {dict(ran)}, expected {want}")
            del cpu_step
            release_graphs()
        reset_launches()   # the batch-1 comparisons are not the path's launches
        tables[tag] = rows
        print(f"profile {tag}: {time.perf_counter() - t1:.1f} s")
    print(json.dumps({"profiles": {tag: [{k: r[k] for k in ("name", "mean_s", "gflops",
                                                           "tflops_per_s", "hbm_gb",
                                                           "temp_mb")} for r in rows]
                                   for tag, rows in tables.items()}, "card": smi}))
    print(f"profiles phase: {time.perf_counter() - t0:.1f} s")
    return {name: counts[name] for name in COUNTERS}


def eval_phase():
    """The evaluation drivers: ``eval/ex1_burgers_eval.py`` of the port on
    the reference's checkpoint (galerkin, subsample 4, the calibration's
    2148 samples and batches of 16, `checkpoints_phase`'s data), within
    TOL_ANCHOR of the reference's 1.4932e-3; ``eval/ex2_darcy_eval.py`` on
    the checkpoint that `darcy_421_phase` wrote (at its grids, its data
    made afresh), printed beside that driver's validation metric.  Every
    request's graph launches ``galerkin_scores`` in every encoder layer.
    Returns the launch counts, the replays included."""
    reset_launches()
    t0 = time.perf_counter()
    args = ex1_burgers_eval.parser().parse_args(
        [ANCHOR, "--attention-type", "galerkin", "--subsample", str(SUBSAMPLE), "--n-samples",
         str(ANCHOR_SAMPLES), "--val-batch-size", str(ANCHOR_VAL_BATCH)])
    metric, pred, ds = ex1_burgers_eval.evaluate(args)
    forwards = [c.forward for c in pred._captured.values()]
    rel = abs(metric - ANCHOR_METRIC) / ANCHOR_METRIC
    print(f"eval ex1 (port driver) on {os.path.basename(ANCHOR)}: validation metric "
          f"{metric:.6e} on {len(ds)} fields at n={ds.n_grid} vs the reference's "
          f"{ANCHOR_METRIC:.4e}: rel gap {rel:.3e} (tol {TOL_ANCHOR:.0e}); "
          f"{len(forwards)} request shapes; {time.perf_counter() - t0:.1f} s")
    if not rel <= TOL_ANCHOR:
        raise AssertionError("eval ex1: the validation metric is off the reference's")
    t1 = time.perf_counter()
    ckpt, driver_val = KEPT.pop("ex2_421")
    try:
        with fresh_data_dir():
            args2 = ex2_darcy_eval.parser().parse_args(
                [ckpt, "--subsample-attn", "10", "--n-samples", str(DARCY_421_SAMPLES)])
            metric2, pred2, n_grid = ex2_darcy_eval.evaluate(args2)
    finally:
        shutil.rmtree(os.path.dirname(ckpt))
    forwards2 = [c.forward for c in pred2._captured.values()]
    print(f"eval ex2 (port driver) on the ex2 421 checkpoint: validation metric "
          f"{metric2:.4e} at n={n_grid} (normalizer from {4 * DARCY_421_SAMPLES} fresh training "
          f"samples), the driver's last validation metric {driver_val:.4e}; "
          f"{len(forwards2)} request shapes; {time.perf_counter() - t1:.1f} s")
    for tag, fw, layers in (("ex1", forwards, 4), ("ex2", forwards2, 6)):
        for forward in fw:
            got = dict(wrapper_launches(forward.kernels()))
            if got != {"galerkin_scores": layers}:
                raise AssertionError(f"eval {tag}: a request holds {got}")
    if not math.isfinite(metric2):
        raise AssertionError(f"eval ex2: metric {metric2}")
    counts = Counter(launches())
    counts.update(forward_launches(forwards + forwards2))
    print(f"eval phase: {time.perf_counter() - t0:.1f} s")
    return {name: counts[name] for name in COUNTERS}


# parallel phase: the multi-device paths on the one card.  World 1 over NCCL
# (all-reducing one rank is the identity), then two ranks sharing cuda:0 over
# gloo (NCCL refuses two ranks on one device; gloo takes CUDA tensors)
PAR_N = RESOLUTIONS[0]        # ex1 at the full 2^13 grid
PAR_STEPS = 3
PAR_REQUESTS = 3
PAR_GRID_2D = GRIDS_2D[1]     # (211, 71): 71² = 5041 coarse tokens, padded to 5042
PAR_JOIN_S = 240              # each spawn's limit: a hung collective fails the phase
# world 1: the mesh step and request against the same ones without a mesh
TOL_PAR_WORLD1 = 1e-6
# two ranks: losses relative, parameters (rtol, atol) after three steps, as
# JAX holds its sequence-parallel step to its unsharded one
# (tests/test_parallel.py::test_seq_parallel_train_step_matches_unsharded)
TOL_PAR_LOSS = 2e-5
TOL_PAR_PARAM = (1e-4, 1e-5)


def _par_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return np.random.default_rng(SEED)


def _par_train_batch(rng, n=PAR_N):
    batch = make_batch(rng, n)
    batch["target"] = rng.standard_normal((BATCH, n, 2)).astype(np.float32)
    return batch


def _par_steps(mesh=None, seq_mesh=None, dtype=None):
    """A full-width ex1 galerkin model (dropout off) and its steps, on a
    `mesh` (the steps' gradient averaging) and with a `seq_mesh`."""
    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = "galerkin"
    model = no_dropout(SimpleTransformer.from_config(cfg, device="cuda", seed=SEED,
                                                     dtype=dtype, seq_mesh=seq_mesh))
    opt = AdamOneCycle(model.parameters(), 1e-3, 100)
    h = 1 / PAR_N
    train_step, _ = make_burgers_steps(model, WeightedL2Loss(regularizer=True, h=h, gamma=0.1),
                                       WeightedL2Loss(h=h), opt, mesh=mesh)
    return model, train_step


def _par_run_steps(step, batches):
    """Losses of one step per batch, and the wrappers' launches over them."""
    reset_launches()
    losses = [[float(x) for x in step(b)] for b in batches]
    return losses, launches()


def _par_loss_err(losses, want) -> tuple:
    """(largest relative, largest absolute) gap of `losses` from `want`
    (lists of steps' losses); NaN when any loss is not finite, so that no
    tolerance passes it."""
    a, b = np.asarray(losses, np.float64), np.asarray(want, np.float64)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return math.nan, math.nan
    gap = np.abs(a - b)
    return (float(np.max(gap / np.where(b != 0, np.abs(b), np.inf))),
            float(np.max(gap)))


def _par_param_err(model, ref, rtol, atol) -> float:
    """The largest |a - b| / (atol + rtol |b|) over every parameter (<= 1
    passes); NaN when any parameter of either model is not finite."""
    ref = dict(ref.named_parameters())
    with torch.no_grad():
        if not all(bool(torch.isfinite(p).all() and torch.isfinite(ref[k]).all())
                   for k, p in model.named_parameters()):
            return math.nan
        return float(torch.stack([((p - ref[k]).abs() / (atol + rtol * ref[k].abs())).max()
                                  for k, p in model.named_parameters()]).max())


def _par_grad_err(model, ref) -> tuple:
    """The largest gap of a gradient of `model` from that of `ref`, over
    the largest entry of the reference's (as `compare_step` holds them),
    and its parameter; NaN when any gradient is not finite."""
    ref = dict(ref.named_parameters())
    worst, key = 0.0, ""
    for k, p in model.named_parameters():
        err, scale = max_err(p.grad, ref[k].grad)
        rel = err / scale if scale > 0 else err
        if not (math.isfinite(rel) and bool(torch.isfinite(p.grad).all())):
            return math.nan, k
        if rel > worst:
            worst, key = rel, k
    return worst, key


def _par_collective_ms(collective, iters: int = 20) -> float:
    """Host-clock ms of one `collective()` on the card, synchronized."""
    for _ in range(3):
        collective()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        collective()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def _par_allreduce_ms(group) -> float:
    """ms of one all-reduce of the ex1 scores (8, 1, 97, 97) f32."""
    s = torch.randn(BATCH, 1, 97, 97, device="cuda")
    return _par_collective_ms(lambda: torch.distributed.all_reduce(s, group=group))


def _par_allgather_ms(mesh) -> float:
    """ms of the sharded ex1 encoder's exit: the all-gather of each rank's
    rows of the (8, 8192, 96) f32 output."""
    from galerkin_transformer_torch.parallel import gather_rows
    from galerkin_transformer_torch.parallel.galerkin import axis_rows

    rows = axis_rows(mesh, PAR_N)
    x = torch.randn(BATCH, rows.stop - rows.start, 96, device="cuda")
    return _par_collective_ms(lambda: gather_rows(x, mesh, PAR_N), iters=5)


def _par_world1(rank, world, out_dir):
    """NCCL, one rank: three ex1 steps with the mesh against three without,
    `Predictor(mesh=)` against `Predictor`, and the all-reduce's time."""
    from galerkin_transformer_torch.parallel import make_mesh

    rng = _par_setup()
    mesh = make_mesh(data=1, seq=1)
    batches = [_par_train_batch(rng) for _ in range(PAR_STEPS)]
    meshed, step = _par_steps(mesh=mesh)
    plain, plain_step = _par_steps()
    losses, counts = _par_run_steps(step, batches)
    want, _ = _par_run_steps(plain_step, batches)
    loss_err, _ = _par_loss_err(losses, want)
    param_err = _par_param_err(meshed, plain, TOL_PAR_WORLD1, 0.0)
    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = "galerkin"
    requests = [make_batch(rng, PAR_N) for _ in range(PAR_REQUESTS)]
    reset_launches()
    served = Predictor(SimpleTransformer.from_config(cfg, seed=SEED), mesh=mesh)
    outs = [served(b) for b in requests]
    serve_counts = Counter(launches())
    serve_counts.update(forward_launches([served.captured(requests[0])]))
    refs = [Predictor(SimpleTransformer.from_config(cfg, seed=SEED))(b) for b in requests]
    serve_err = float(np.max([np.abs(o - r).max() / np.abs(r).max() for o, r in zip(outs, refs)]))
    if not all(np.isfinite(o).all() for o in outs):
        serve_err = math.nan
    counts = Counter(counts)
    counts.update(serve_counts)
    result = dict(losses=losses, loss_err=loss_err, param_err=param_err,
                  serve_err=serve_err, launches=dict(counts),
                  allreduce_ms=_par_allreduce_ms(mesh.groups["seq"]),
                  backend=torch.distributed.get_backend())
    with open(os.path.join(out_dir, f"world1_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _par_serve(tag, sharded, plain, batches, kernel, per_request, tol, scale_of):
    """`sharded` (a Predictor of a model with a seq mesh: eager requests)
    against `plain` (the one-process kernel path, captured) on `batches`:
    the launches of `kernel` per request, the error over `scale_of` the
    reference, and the median request times."""
    reset_launches()
    outs, ms = timed_requests(sharded, batches)
    counts = launches()
    if counts[kernel] != per_request * len(batches):
        raise AssertionError(f"{tag}: {counts[kernel]} launches of {kernel} over "
                             f"{len(batches)} requests, expected {per_request} each")
    plain.warmup(batches[0])
    refs, plain_ms = timed_requests(plain, batches)
    err = max(float(np.abs(o - r).max()) / scale_of(r) for o, r in zip(outs, refs))
    if not all(np.isfinite(o).all() and o.shape == r.shape for o, r in zip(outs, refs)) \
            or not err <= tol:
        raise AssertionError(f"{tag}: sharded requests {err:.3e} from the one-process "
                             f"path (tol {tol:.1e})")
    return dict(err=err, tol=tol, ms=statistics.median(ms), plain_ms=statistics.median(plain_ms),
                launches=dict(counts))


def _par_partial_ms(mesh, rng, dtype) -> dict:
    """Device ms of this rank's local partial (its n/2 rows) and of the
    one-process kernel on all n rows, at the ex1 shape, and the kernels one
    local call launches (a graph captured from it)."""
    from galerkin_transformer_torch.parallel import axis_rows
    from galerkin_transformer_torch.parallel.galerkin import _local_scores

    k, v, pos, params = galerkin_inputs(rng, torch.device("cuda"), EX1_SHAPE, dtype)
    rows = axis_rows(mesh, k.shape[2])
    local = [t[:, :, rows].contiguous() for t in (k, v)] + [pos[:, rows].contiguous()]
    part = lambda: _local_scores(*local, params, 1e-5)
    whole = lambda: GS.galerkin_scores(k, v, pos, *params, 1e-5)
    part(), whole()
    out = dict(rows=rows.stop - rows.start,
               kernels=dict(wrapper_launches(launched_kernels(part))))
    for turn in range(mesh.shape["seq"]):   # one rank times while the others wait
        torch.distributed.barrier(group=mesh.groups["seq"])
        if turn == mesh.index["seq"]:
            out.update(part_ms=device_ms(part), whole_ms=device_ms(whole))
        torch.cuda.synchronize()
    torch.distributed.barrier(group=mesh.groups["seq"])
    return out


def _par_world2(rank, world, out_dir):
    """Gloo, two ranks on cuda:0, a 1 x 2 (data x seq) mesh: ex1 galerkin f32
    and bf16 served with the seq mesh at n = 8192, three f32 steps and one
    bf16 step, each against the one-process kernel path; ex2 served with the
    seq mesh at the 421 grid's (211, 71); the local partial's time and the
    all-reduce's."""
    from galerkin_transformer_torch.parallel import make_mesh

    t0 = time.perf_counter()
    rng = _par_setup()
    mesh = make_mesh(data=1, seq=2)
    result, counts = {}, Counter()
    cfg = load_config("ex1_burgers")
    cfg["attention_type"] = "galerkin"
    requests = [make_batch(rng, PAR_N) for _ in range(PAR_REQUESTS)]
    for dtype in DTYPES:
        sharded = Predictor(SimpleTransformer.from_config(cfg, seed=SEED, dtype=dtype,
                                                          seq_mesh=mesh), mesh=mesh)
        plain = Predictor(SimpleTransformer.from_config(cfg, seed=SEED, dtype=dtype))
        tag = f"ex1 galerkin {dtype_name(dtype)} n={PAR_N}"
        result[tag] = r = _par_serve(
            tag, sharded, plain, requests, KERNEL_OF["galerkin", dtype],
            cfg["num_encoder_layers"], TOL_SERVE if dtype is None else TOL_SERVE_BF16,
            lambda ref: float(np.abs(ref).max()))
        counts.update(r["launches"])
        result[f"partial {dtype_name(dtype)}"] = _par_partial_ms(mesh, rng, dtype)
    batches = [_par_train_batch(rng) for _ in range(PAR_STEPS)]
    sharded, step = _par_steps(mesh=mesh, seq_mesh=mesh)
    plain, plain_step = _par_steps()
    losses, step_counts = _par_run_steps(step, batches)
    want, _ = _par_run_steps(plain_step, batches)
    per_step = LAUNCHES_PER_STEP["galerkin", None]
    if any(step_counts[k] != n * PAR_STEPS for k, n in per_step.items()):
        raise AssertionError(f"ex1 seq-parallel steps launched {step_counts}, expected "
                             f"{per_step} per step")
    counts.update(step_counts)
    loss_err, loss_gap = _par_loss_err(losses, want)
    param_err = _par_param_err(sharded, plain, *TOL_PAR_PARAM)
    if not (loss_err <= TOL_PAR_LOSS and param_err <= 1.0):
        raise AssertionError(f"ex1 seq-parallel steps: losses {losses} vs {want} "
                             f"({loss_err:.3e}), parameters {param_err:.3e} of the tolerance")
    result["train"] = dict(losses=losses, loss_err=loss_err, loss_gap=loss_gap,
                           param_err=param_err)
    # one bf16 step: the sharded backward in JAX's cast order (the partial in
    # f32, all-reduced, divided, cast) against the one-process bf16 step, at
    # the bf16 train step's tolerances
    del sharded, step, plain, plain_step
    sharded, step = _par_steps(mesh=mesh, seq_mesh=mesh, dtype=torch.bfloat16)
    plain, plain_step = _par_steps(dtype=torch.bfloat16)
    losses, step_counts = _par_run_steps(step, batches[:1])
    want, _ = _par_run_steps(plain_step, batches[:1])
    per_step = LAUNCHES_PER_STEP["galerkin", torch.bfloat16]
    if any(step_counts[k] != n for k, n in per_step.items()):
        raise AssertionError(f"ex1 seq-parallel bf16 step launched {step_counts}, expected "
                             f"{per_step}")
    counts.update(step_counts)
    loss_err, _ = _par_loss_err(losses, want)
    grad_err, worst = _par_grad_err(sharded, plain)
    if not (loss_err <= TOL_TRAIN_LOSS_BF16 and grad_err <= TOL_TRAIN_GRAD_BF16):
        raise AssertionError(f"ex1 seq-parallel bf16 step: losses {losses} vs {want} "
                             f"({loss_err:.3e}), gradient of {worst} {grad_err:.3e} of its "
                             f"largest entry")
    result["train_bf16"] = dict(losses=losses, loss_err=loss_err, grad_err=grad_err,
                                worst=worst)
    del sharded, step, plain, plain_step
    n_f, n_c = PAR_GRID_2D
    cfg2 = {**ex2_config(n_f, n_c), **NO_DROPOUT}
    normalizer = ((0.1 * rng.standard_normal((n_f, n_f, 1))).astype(np.float32),
                  rng.uniform(0.5, 1.5, (n_f, n_f, 1)).astype(np.float32), np.float32(1e-5))
    pos, grid = darcy_grids(n_f, n_c)
    requests = [dict(node=rng.standard_normal((BATCH_2D, n_f, n_f, 1)).astype(np.float32),
                     pos=pos[None].repeat(BATCH_2D, 0), grid=grid[None].repeat(BATCH_2D, 0))
                for _ in range(PAR_REQUESTS)]

    def variation(out):
        """How far the model's part of the output moves (as serving_2d_phase)."""
        mean, std, eps = normalizer
        part = ((out - mean) / (std + eps))[:, 1:-1, 1:-1]
        return float(np.abs(part - part.mean()).max())

    tag = f"ex2 galerkin f32 (n_f,n_c)=({n_f},{n_c}) batch={BATCH_2D}"
    result[tag] = r = _par_serve(
        tag, Predictor(FourierTransformer2D.from_config(cfg2, seed=SEED, seq_mesh=mesh),
                       normalizer=normalizer, mesh=mesh),
        Predictor(FourierTransformer2D.from_config(cfg2, seed=SEED), normalizer=normalizer),
        requests, "galerkin_scores", cfg2["num_encoder_layers"], TOL_SERVE, variation)
    counts.update(r["launches"])
    result.update(launches=dict(counts), allreduce_ms=_par_allreduce_ms(mesh.groups["seq"]),
                  allgather_ms=_par_allgather_ms(mesh),
                  backend=torch.distributed.get_backend(), seconds=time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"world2_rank{rank}.json"), "w") as f:
        json.dump(result, f)


def parallel_phase(smi: str):
    """The multi-device paths: `_par_world1` over NCCL, then `_par_world2`
    on two ranks sharing the card over gloo, each rank a spawned process
    (``parallel.spawn``: any rank's failure fails the phase).  Prints each
    rank's readings; returns the launches of the mesh runs, summed over the
    ranks (the one-process references not counted)."""
    from galerkin_transformer_torch.parallel import spawn

    t0 = time.perf_counter()
    counts = Counter()
    with tempfile.TemporaryDirectory() as out_dir:
        spawn(_par_world1, 1, args=(out_dir,), device="cuda", join_s=PAR_JOIN_S)
        spawn(_par_world2, 2, args=(out_dir,), device="cuda", backend="gloo",
              join_s=PAR_JOIN_S)
        results = {}
        for name in ("world1_rank0", "world2_rank0", "world2_rank1"):
            with open(os.path.join(out_dir, f"{name}.json")) as f:
                results[name] = json.load(f)
    w1 = results["world1_rank0"]
    if not (w1["loss_err"] <= TOL_PAR_WORLD1 and w1["param_err"] <= 1.0
            and w1["serve_err"] <= TOL_PAR_WORLD1):
        raise AssertionError(f"parallel world 1: {w1}")
    print(f"parallel world 1 ({w1['backend']}, {smi}): ex1 galerkin f32 n={PAR_N} "
          f"batch={BATCH}: {PAR_STEPS} mesh steps vs plain steps, losses {w1['losses']} "
          f"(max rel err {w1['loss_err']:.3e}), parameters {w1['param_err']:.3e} of "
          f"{TOL_PAR_WORLD1:.0e} relative; Predictor(mesh=) {w1['serve_err']:.3e} from "
          f"Predictor; all-reduce of (8,1,97,97) f32 {w1['allreduce_ms']:.4f} ms; "
          f"launches {w1['launches']}")
    counts.update(w1["launches"])
    for rank in range(2):
        r = results[f"world2_rank{rank}"]
        counts.update(r["launches"])
        print(f"parallel world 2 rank {rank} ({r['backend']} on cuda:0, {smi}): "
              f"{r['seconds']:.1f} s; all-reduce of (8,1,97,97) f32 "
              f"{r['allreduce_ms']:.4f} ms; all-gather of the (8,{PAR_N},96) f32 encoder "
              f"output {r['allgather_ms']:.3f} ms; launches {r['launches']}")
        for tag, s in r.items():
            if isinstance(s, dict) and "err" in s:
                print(f"  serve {tag} seq 1x2: median request {s['ms']:.2f} ms (eager) vs "
                      f"{s['plain_ms']:.2f} ms one process (captured); err {s['err']:.3e} "
                      f"(tol {s['tol']:.1e})")
            elif tag.startswith("partial"):
                print(f"  {tag} local partial ({s['rows']} of {PAR_N} rows): "
                      f"{s['part_ms']:.4f} ms vs {s['whole_ms']:.4f} ms one-process kernel "
                      f"on all rows; one local call launches {s['kernels']}")
        t = r["train"]
        print(f"  train ex1 galerkin f32 seq 1x2: losses {t['losses']} (max rel err "
              f"{t['loss_err']:.3e}, max abs {t['loss_gap']:.3e}, tol {TOL_PAR_LOSS:.0e}); "
              f"parameters {t['param_err']:.3e} of (rtol, atol) {TOL_PAR_PARAM}")
        t = r["train_bf16"]
        print(f"  train ex1 galerkin bf16 seq 1x2, one step vs one process: losses "
              f"{t['losses']} (max rel err {t['loss_err']:.3e}, tol {TOL_TRAIN_LOSS_BF16:.0e}); "
              f"gradients max err/max|g| {t['grad_err']:.3e} at {t['worst']} (tol "
              f"{TOL_TRAIN_GRAD_BF16:.1e})")
    print(f"parallel phase: {time.perf_counter() - t0:.1f} s")
    return {name: counts[name] for name in COUNTERS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Build, check and drive the port on one GPU.")
    parser.add_argument("--against", nargs="+", metavar="ROOT",
                        help="only time the redesigned kernels of this checkout "
                             "against those of other checkouts of the port (e.g. an "
                             "earlier commit unpacked with git archive)")
    parser.add_argument("--kernel", nargs="+", choices=tuple(AB_SHAPES),
                        help="with --against: time these kernels only")
    parser.add_argument("--cosine-bf16", action="store_true",
                        help="only print bf16 cosine serving's distance from the float32 "
                             "model on four seeds, ex1 and ex2 (the readings behind "
                             "TOL_SERVE_COSINE_BF16 and TOL_SERVE_COSINE_BF16_2D)")
    parser.add_argument("--profile-float64", action="store_true",
                        help="only print the profiles' galerkin and fourier gradient "
                             "steps at batch 1 (card, card plain route, CPU) against "
                             "float64 (the readings behind PROFILE_GRAD_FLOOR)")
    parser.add_argument("--stage-sweep", action="store_true",
                        help="only time the float32 galerkin forward's stages at the "
                             "ex1 width over n (stage_sweep_phase)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    peak = peaks_for(name)
    if args.against:
        names = tuple(AB_SHAPES) if args.kernel is None else tuple(args.kernel)
        print(json.dumps({"card": smi, **against_phase(args.against, names)}))
        return 0
    if args.cosine_bf16:
        print(json.dumps({"card": smi, "cosine_bf16": cosine_bf16_phase()}))
        return 0
    if args.stage_sweep:
        print(json.dumps({"card": smi, "stage_sweep": stage_sweep_phase()}))
        return 0
    if args.profile_float64:
        print(json.dumps({"card": smi, "profile_float64": profile_float64_phase()}))
        return 0

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {_build.sources()} in {time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for line in ptxas_summary(log):
            print(f"  {src}: {line}")

    rng = np.random.default_rng(SEED)
    bf16 = torch.bfloat16
    t_kernels = time.perf_counter()
    kernels = [fourier_phase(rng, dev, peak), galerkin_phase(rng, dev, peak),
               galerkin_bwd_phase(rng, dev, peak),
               galerkin_phase(rng, dev, peak, EX2_SHAPE, bf16, eps=1e-7),
               fourier_phase(rng, dev, peak, bf16),
               galerkin_bwd_phase(rng, dev, peak, EX2_TRAIN_SHAPE, bf16, eps=1e-7),
               fourier_bwd_bf16_phase(rng, dev, peak)]
    # the same kernels at the other main paths' shapes (printed, not in the line)
    galerkin_phase(rng, dev, peak, EX2_SHAPE, eps=1e-7)
    galerkin_phase(rng, dev, peak, EX2_TRAIN_SHAPE, eps=1e-7)
    galerkin_phase(rng, dev, peak, dtype=bf16)
    galerkin_phase(rng, dev, peak, EX2_TRAIN_SHAPE, bf16, eps=1e-7)
    galerkin_bwd_phase(rng, dev, peak, dtype=bf16)
    galerkin_bwd_phase(rng, dev, peak, EX2_TRAIN_SHAPE, eps=1e-7)
    fourier_bwd_phase(rng, dev, peak)
    # and at the encoder profile's (4 heads of d_k 32 and one pos column; the
    # chains at d = 33), which no model of the other paths has; their inputs
    # from a generator of their own, so the other phases draw what they drew
    enc, enc_rng = encoder_memory_profile.parser().parse_args([]), np.random.default_rng(SEED)
    d_k = enc.d_model // enc.n_head
    enc_scores = (enc.batch_size, enc.n_head, enc.seq_len, d_k, 1)
    enc_chain = (enc.batch_size * enc.n_head, enc.seq_len, d_k + 1)
    galerkin_phase(enc_rng, dev, peak, enc_scores)
    galerkin_bwd_phase(enc_rng, dev, peak, enc_scores)
    fourier_phase(enc_rng, dev, peak, shape=enc_chain)
    fourier_bwd_phase(enc_rng, dev, peak, enc_chain)
    wide_phase(rng, dev)
    t_paths = time.perf_counter()
    paths, seconds = [], []
    for phase in (lambda: serving_phase(rng), lambda: serving_2d_phase(rng),
                  lambda: serving_ex4_phase(rng), training_phase, training_2d_phase,
                  ex4_phase, device_loop_phase, lambda: recovery_phase(smi), driver_phase,
                  lambda: ex1_variants_phase(rng), lambda: variants_2d_phase(rng),
                  checkpoints_phase, generators_phase, darcy_421_phase, graph_phase,
                  random_features_phase, lambda: decoder_phase(rng),
                  lambda: profiles_phase(smi), eval_phase, lambda: parallel_phase(smi)):
        release_graphs()   # the graphs of the phases before
        t1 = time.perf_counter()
        paths.append(phase())
        seconds.append(round(time.perf_counter() - t1, 1))
    print(f"launches by main path (ex1 serving, ex2 serving, ex4 serving, ex1 training, "
          f"ex2 training, ex4 training, device loop, recovery, drivers, ex1 variants, "
          f"2D variants, checkpoints, generators, ex2 at 421, graph, random features, "
          f"decoder, profiles, eval, parallel): "
          f"{paths}")
    print(f"phase seconds (kernel phases, then the paths in that order): "
          f"{round(t_paths - t_kernels, 1)}, {seconds}; {time.perf_counter() - t0:.1f} s "
          f"with the build")
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in paths)
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']} was never launched on the main path")
    keys = ("name", "route", "source", "replaces", "shape", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys} for k in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
