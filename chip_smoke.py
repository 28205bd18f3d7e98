#!/usr/bin/env python3
"""Quickest proof that the PyTorch port runs on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

  1. device  — requires CUDA; prints the card's name and power limit
               (nvidia-smi); TF32 off for matmuls and cuDNN.
  2. build   — builds the port's Hopper kernels from ``src/repro_torch/csrc``
               and prints the build seconds.
  3. kernels — each kernel against its plain PyTorch version on the card at
               the main path's shapes (BERT-Large, d_pad = 364,564,480,
               block 4096), with CUDA-event times of both and the
               device-memory bound; the LM head's kernels forward and
               backward at the main path's head (16 x 128 tokens, d 1,024,
               V 30,528, 8 vocab segments a row tile) and at
               internlm2-1.8b's rank-1 half vocab at tp 2, timed at the
               main path's head beside the f32 torch path they replaced
               (``benchmarks/lm_head_bench.py``).
  4. small   — the port's ``run`` on ``bert-large-smoke`` on the card and on
               the CPU from the same seed: the loss histories must agree.
  5. main    — the main path through the user entry point
               ``repro_torch.launch.train.run``: full-width, full-depth
               BERT-Large, 3 warmup + 3 compressed 1-bit Adam steps, batch
               16 x seq 128; launch counts read around exactly this run.
  6. profile — one more warmup-stage and compressed-stage step on the
               main path's model under torch.profiler: device time by
               kernel group and the device's idle share (measurement only).
  6b. family — the optimizer family at full BERT-Large width and depth
               (batch 16 x seq 128, block 4096, seed 0): first
               ``bert-large-smoke`` on the card and on the CPU under
               ``onebit_lamb`` and ``zerone_adam_local`` (losses agree);
               then five runs, launch counts set to 0 before and checked
               after each: 1-bit LAMB (3 + 3 steps), 0/1 Adam under the
               local layout through ``train_step`` (3 + 5 steps with 0-bit
               steps and ``v`` refreshes), 1-bit Adam over top-k (3 + 3),
               1-bit Adam with ``accum_steps=2`` whose compressed steps
               run under zero1 (warmup losses held to phase 5's), and a
               checkpoint resume (4 steps, save, load back bitwise,
               resume to 6 against uninterrupted runs).
  6c. pipeline — the bucketed pipelined exchange with backward overlap:
               first ``bert-large-smoke`` with ``pipeline=4,
               overlap_bwd="on"`` on the card and on the CPU (losses
               agree as phase 4's do; on the card bitwise the serial run);
               then the main path again through ``run`` at full
               BERT-Large (3 + 3 steps, seed 0, batch 16 x seq 128, block
               4096) with 4 buckets (22,251 / 22,251 / 22,251 / 22,252
               alignment units of 4096) and backward overlap: losses and
               the final x, m, worker_err and server_err bitwise phase 5's
               (host copies taken before phase 6 moved the state on);
               launch counts 3 / 24 / 24 read around exactly this run;
               3 of the 4 stage 0s issued before backward's last gradient
               (the embedding's) lands; peak memory; one compressed step
               profiled as in phase 6 (device-to-device copy time beside
               phase 6's).
  7. flash   — the three flash-attention routes against their plain version
               on the card: the f32 route (the split kernel on the tensor
               cores) on small f32 shapes (S 128/256/512, D 32/64/128,
               causal and not, windows 32/64/128); the wgmma kernel (the
               bf16/fp16 route) on ragged fp16 shapes; head dims
               48/80/96/256 (zero-padded) in f32, bf16 and fp16; head dims
               320/512/1000 (the wide route, the split kernel) in f32, bf16
               and fp16; then, each beside PyTorch's
               scaled_dot_product_attention in the same dtype (timed only),
               its plain version and its bound: the wide route at (2, 8,
               1024, 512) bf16 causal, the f32 route at (8, 24, 2048, 128)
               f32 causal (with the split's own floor), and the wgmma kernel
               at (8, 24, 2048, 128) bf16 causal, timed by
               ``repro_torch.benchmarks.flash_bench`` on the checked
               inputs (CUDA events around one call; run alone, that script
               also reads the profiler's device time of each launch); the
               HGMMA instructions in each split-kernel instance's own SASS
               (cuobjdump -sass, cut at each function's header; phase 7
               fails where there is none or no cuobjdump).
  8. serve-small — the port's ServeEngine on ``llama3.2-3b-smoke`` with
               attn_impl="pallas", on the card and on the CPU from one seed:
               prefill logits and 8 teacher-forced decode steps agree (the
               card's f32 prefill runs the f32 route once per layer).
  9. serve-main — the serving path through the user entry point
               ``repro_torch.serve.ServeEngine.generate``: full-width,
               full-depth llama3.2-3b, random weights from seed 0, batch 8
               x 2048-token prompts, 32 greedy new tokens; launch counts
               read around exactly this run (28 launches of the wgmma
               kernel, none of the other routes).
  9b. serve-f32 — the same entry point on full llama3.2-3b with
               compute_dtype="float32" and attn_impl="pallas" (random
               weights from seed 0, batch 8 x 2048-token prompts, 4 new
               tokens): launch counts read around exactly this run (28 of
               the f32 route, none of the others), prefill ms and peak
               memory; the last-position logits against the same engine
               with attn_impl="full" (TF32 off).
 10. serve-profile — one prefill and one decode step under torch.profiler
               (measurement only).
 11. oracles — the functional 1-bit Adam oracles
               (``repro_torch.core.onebit_adam``) against the registry
               ``onebit_adam`` (built from the same ``OneBitAdamConfig``) at
               full BERT-Large (batch 16 x seq 128, block 4096, d_pad =
               364,564,480, seed 0): 3 warmup + 3 compressed steps, each
               step's flat f32 gradient from the main path's model, both
               updates from the same state; x, m, v, worker_err and
               server_err bitwise in the compressed stage, at rtol 1e-6 of
               their terms in the warmup (the fused kernel squares g in
               another order); then one zero1 step against the registry's
               zero1 update (bitwise); launch counts set to 0 around the
               oracle's own updates (0 / 6 / 6, zero1 0 / 2 / 2); CUDA-event
               ms of each update; peak memory.
 12. claims — the paper's claim benchmarks on the card at the reference's
               sizes: ``block_size_ablation.run``,
               ``variance_stability.run(segments=8)`` and
               ``convergence.run`` (nine 160-step runs of the reduced
               internlm2-1.8b), then the variance system phase at full
               BERT-Large (b2 0.97, 80 warmup steps, batch 16 x seq 128,
               block 4096, lr 1e-4): the step where the Sec. 7.1 rule
               fires and the ratio.  Each part's launch counts set to 0
               before and read after it (every kernel on its path must
               launch); a FAIL verdict is printed, not raised.  Prints the
               ``{"claims": {...}}`` line.
 13. plan   — planning on the card: ``repro_torch.benchmarks.kernel_sweep``
               into a temporary JSON, loaded by
               ``DeviceSpec.from_measured(..., base="h100-sxm")``; the
               fitted HBM bandwidth, launch overhead and peak FLOP/s beside
               the data sheet's (a clamped fit or a share above 105 %
               fails); then the main path through ``run`` with
               ``topology``, ``pipeline`` and ``overlap_bwd`` all "auto"
               on the ``ethernet-10g`` cluster and the calibrated spec
               (full BERT-Large, 3 + 3 steps, seed 0): the tuner's pick
               and table, launch counts read around exactly this run
               (3 / 6 per bucket / 6 per bucket), losses and the final x,
               m, worker_err and server_err bitwise phase 5's (the host
               copies phase 6c is held to); then ``predict_step_time`` of
               the main path's compressed plan on the calibrated spec
               beside phase 5's compressed walls and phase 6's device-busy
               ms, and their ratios (a measurement only).  Prints the
               ``{"plan": {...}}`` line.
 14. obs    — observability (``repro_torch.obs``).  14a, in this process:
               ``run`` on the main path (full BERT-Large, 3 + 3 steps, seed
               0) with ``telemetry``, ``memory="on"`` and ``audit="on",
               audit_every=1``: losses and the final x, m, worker_err and
               server_err bitwise phase 5's; launch counts read around
               exactly this run (phase 5's plus one ef_compress and one
               decompress an audited step); the log validates
               (``repro_torch.obs.events.validate_records``) with 6 step,
               3 fidelity and 3 audit health events, one predicted and
               one measured (``compiled``) memory event for each step
               program, and live samples; each measured program's
               attributed + residual equals its total; the predicted and
               measured peaks beside phase 5's, the compressed walls beside
               phase 5's.  14b, in a fresh process (a second profiler
               session in one process once read no device time): the CLI
               ``python -m repro_torch.launch.train`` with 4 buckets,
               backward overlap, ``--telemetry``, ``--profile`` of the last
               2 steps, ``--memory on`` and ``--bench obs_smoke``: exit 0,
               one ``profile`` event with t_attributed > 0 and
               t_attributed + t_residual = t_window, a cell for every
               (bucket, stage) op of ``pipe(flat/onebit)x4`` and the
               ready-order table, a ``BENCH_obs_smoke.json`` that
               ``load_ledger`` reads.  Then the predicted ledgers of phase
               6b's zero1 run with accumulation 2 (host math only) beside
               the peak phase 6b measured.  Prints the ``{"obs": {...}}``
               line.
 15. families — the model families (MoE, the Mamba-1 SSM, the Jamba
               hybrid, the audio and VLM input stubs).  15a: the reduced()
               config of each of the eight archs beyond BERT and the dense
               decoders (and the MoE one under the gather dispatch)
               through ``run`` on the card and on the CPU from one seed, 3
               warmup + 2 compressed steps, batch 4 x seq 64 (80 for the
               VLM: 64 text tokens after the 16-patch prefix), block 512:
               launch counts 3 / 4 / 4, aux > 0 with experts and 0
               without, the losses of steps 0-3 (taken before any
               compressed update) within SMALL_LOSS_RTOL, the first
               compressed payload's sign bits at most 1e-3 apart (the
               step's local momentum on each device from the CPU's state
               after the warmup); step 4's loss reported.  15b: the
               full-width path, falcon-mamba-7b at its published widths (d
               4096, d_inner 8192, state 16, conv 4, dt_rank 256, vocab
               65,024, bf16) cut to 2 layers, through ``run``: 3 warmup + 3
               compressed 1-bit Adam steps, batch 2 x seq 2048, block 4096,
               seed 0; losses finite, the stage flips at step 3, v_l1
               frozen, launch counts 3 / 6 / 6 read around exactly this
               run; d_pad, the walls, the peak, and one compressed step
               under torch.profiler.  15c: mixtral-8x22b's MoE layer alone
               (d 6144, ff 16384, 8 experts, top-2; f32 parameters from seed
               0, bf16 inputs of batch 2 x seq 4096, capacity 2560):
               forward + backward under the einsum and the gather dispatch,
               outputs and input gradients held to each other at one bf16
               ulp; CUDA-event ms and peak memory of each.  Prints the
               ``{"families": {...}}`` line.
 16. serve-families — the rest of serving (MoE, SSM and hybrid layers with
               their caches, the VLM prefix, the audio stub's frames).
               16a: the reduced() config of mixtral-8x22b (einsum and
               gather), llama4-scout, falcon-mamba-7b, jamba, internvl2-2b
               (its patch prefix) and musicgen-large (frames, through
               ``decode_step``) in f32 with attn_impl="pallas", on the card
               and on the CPU from one seed: prefill logits and 8
               teacher-forced decode steps within SERVE_SMALL_TOL up to the
               first step where a token routes to another expert (counted
               each step); the f32 flash route once per attention layer.
               16b: the full-width path, falcon-mamba-7b at its published
               width and depth (64 layers, d 4096, d_inner 8192, state 16,
               vocab 65,024, bf16, random weights from seed 0) through
               ``ServeEngine.generate``: batch 8 x 2048-token prompts, 32
               greedy new tokens; launch counts read around exactly this
               run (none: the SSM has no kernel); prefill ms, decode ms a
               step, tokens/s, peak memory; one prefill and one decode step
               under torch.profiler.  16c: mixtral-8x22b at full width (d
               6144, 48 q / 8 kv heads, 8 experts top-2, window 4096) cut
               to 2 layers, bf16, attn_impl="pallas": ``generate`` on batch
               2 x 5120-token prompts (past the window: the prefill seeds
               the ring buffer), 16 new tokens; exactly 2 launches of the
               wgmma flash kernel (its windowed route) and no other kernel;
               the kernel against its plain version on layer 0's inputs;
               the last-position logits of the flash route and of
               attn_impl="full" each against the model in f32 (see
               SERVE_MIXTRAL_TOL).  Prints the ``{"serve_families":
               {...}}`` line.
 17. vision  — the paper's ResNet (Sec. 7.2) and DCGAN (Sec. 7.3) claims
               and the benchmark harness, in f32 with TF32 off.  17a: the
               reference-size ResNet (widths (16, 32, 64), 16 x 16, batch
               64, block 256) and DCGAN (batch 64, block 64) on the card
               and on the CPU from one seed, 4 onebit steps with T_w 2: the
               losses through step 2 within SMALL_LOSS_RTOL, the first
               compressed payload's sign bits (the kernel on the card) at
               most FAMILIES_SIGN_FLIP_CEILING apart from the CPU's state;
               the later losses and the free-running payloads' sign bits
               reported.  17b: ``benchmarks.run.ALL``'s
               ``resnet_convergence``, ``dcgan_convergence`` and
               ``kernel_micro`` on the card, launch counts set to 0 before
               each and read after (each must launch ``ef_compress`` and
               ``decompress``; a non-finite number raises), verdicts
               logged PASS or FAIL with their seconds; their ``--json``
               ledger written and read back by ``load_ledger``.  17c: the
               paper's CIFAR shape, ResNet-18's stage widths (64, 128,
               256, 512) at 32 x 32, batch 128: adam and onebit, 150 steps,
               T_w 40: adam's losses all finite, onebit's finite up to
               VISION_CIFAR's ``onebit_nonfinite_at`` and non-finite from
               it on (both raise otherwise); step ms (onebit's over its
               finite and its non-finite steps apart), the losses around
               the switch, last-10 losses, peak memory, launches.
               17d: ``overlap_check`` on one card prints its SKIP.  Prints
               the ``{"vision": {...}}`` line.
 18. tp      — tensor, sequence and expert parallelism (the layout of the
               four-card paths; the paths themselves run on four cards,
               ``tests/test_torch_cuda.py -k nccl_tp``).  18a, on any card:
               the global trees of path A (internlm2-1.8b at full width
               and depth, tp 2) and path B (mixtral-8x22b at full width cut
               to 1 layer, tp 4) drawn on the card, cut into every model
               rank's shards (``convert.shard_params``), each shard's flat
               vector the rank's ``flat_size``, joined back
               (``unshard_params``) bitwise; each rank's flat length,
               padded length and predicted optimizer-state bytes printed;
               then ef_compress, decompress and adam_step on random card
               vectors at each path's padded length, block 4096, against
               their plain versions at phase 3's tolerances (packed signs
               and decompress bitwise), the launch counts set to 0 just
               before and read just after (one each).
               18b, with two or more cards: ``min(count, 4)`` NCCL ranks
               (model axis 2) run the reduced SP / TP parity
               (``tests/_torch_tp_worker.reduced_parity``); with one card
               it prints that it needs two.  Prints the ``{"tp": {...}}``
               line.
 19. tp-serve — tensor-parallel serving and the dry run.  19a:
               granite-34b at full width cut to TP_SERVE["layers"] layers
               (MQA: its one kv head duplicated on the four model ranks):
               the tp 4 serving tree drawn on the card, cut into the four
               model ranks' shards and joined back bitwise; each rank's
               cache shapes from ``make_serve_step(...).init_caches`` on a
               1 x 4 mesh; the predicted bytes a card at full depth
               (weights in bf16 and the caches of batch 8 x 2048 + 32).
               19b: the same model's tp 1 tree in bf16 with
               attn_impl="pallas" through ``make_serve_step`` (prefill,
               then one decode step) bitwise ``prefill`` / ``decode_step``
               called directly; the flash launches of the step's prefill
               set to 0 just before and read just after (one wgmma launch
               a layer, none of the others); the wgmma route at a tp 4
               rank's prefill shape (8, 12, 2048, 128) against its plain
               version at phase 7's tolerance.  19c: the dry run
               (``launch.dryrun.lower_one``, meta tensors, a fake process
               group) of phase 5's configuration (bert-large, batch 16 x
               128, mesh 1 x 1, compressed, block 4096): its traced peak
               and roofline terms printed beside phase 5's
               ``max_memory_allocated`` and phase 6's device-busy ms.
               Prints the ``{"tp_serve": {...}}`` line.
 20. overlap-bwd — ``benchmarks.overlap_check --bwd``'s micro (a chain of
               4 ``tanh(h @ w)`` layers of width 64, 2 buckets, block 512)
               on one rank on the card against the same call on the CPU:
               with the identity compressor the exchange returns the chain
               gradient (rtol 1e-5 / atol 1e-7, TF32 off); with the 1-bit
               compressor on the CPU's gradients landed through the same
               hooks, ef_compress / decompress against their plain
               versions (output +-scale at rtol 1e-6, EF slots at rtol
               1e-5 / atol 1e-6); then the micro's own backward pass with
               the 1-bit exchange, the launch counts set to 0 just before
               and read just after (2 ef_compress and 2 decompress a
               bucket, no adam_step), held to the CPU at the same
               tolerances.  Then ``run_bwd`` on this one card (its rank a
               spawned process, so its profiler session is the first in
               that process) prints SKIP (one rank: no collective) and
               reports the matmul kernels its trace finds through their
               correlation ids.  Prints the
               ``{"overlap_bwd": {...}}`` line.
 21. remat-dots — full BERT-Large with ``remat_policy="dots"`` (the
               superblock recompute keeps the outputs of the products
               without batch dimensions) through ``launch.train.run`` at
               phase 5's parameters, in a spawned process (its profiler
               sessions the first in that process), run right after phase
               6: the launch counts set to 0 just before and read just
               after (phase 5's), the losses and the final flat x bitwise
               phase 5's (x by its SHA-256); then one warmup and one
               compressed step profiled as in phase 6.  Its step ms, peak
               and matmul device ms and kernels are printed beside phase
               5's and phase 6's, in the ``{"remat_dots": {...}}`` line.

Launch counts are set to 0 just before each main path (training in phase
5, each family run in phase 6b, the pipelined run in phase 6c, serving in
phases 9 and 9b, each oracle update in phase 11, each claim benchmark in
phase 12, the sweep and the auto run in phase 13, the observed run in
phase 14a, each card run of phase 15a and the full-width run of 15b, each
card run of phase 16a and the generate calls of 16b and 16c, each harness
entry of 17b, each run of 17c, the prefill of 19b, the micro's 1-bit
run of phase 20 and the "dots" run of phase 21) and read just after it.
It prints the ``{"kernels": [...]}`` line, the card line, and as its
last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the f32 route's bound is f32 operands on the tensor cores at the TF32
# rate (benchmarks/flash_bench.py); the split kernel runs each f32 product
# as six bf16 products, three TF32 passes' worth: its own floor
F32_SPLIT_PASSES = 3

MAIN = dict(arch="bert-large", recipe="onebit_adam", steps=6,
            warmup_steps=3, batch=16, seq=128, block_size=4096)
MAIN_TOKENS = MAIN["batch"] * MAIN["seq"]
SMALL = dict(arch="bert-large-smoke", recipe="onebit_adam", steps=5,
             warmup_steps=3, batch=4, seq=64, block_size=512, lr=2e-3,
             lr_warmup=2)
# cuBLAS and the CPU BLAS sum in other orders; after the switch a ULP
# difference near zero can flip single sign bits of the 1-bit payload
SMALL_LOSS_RTOL = 1e-3


def head_launches(n: int) -> dict:
    """The LM head's launches of ``n`` training losses: its forward and
    its backward once each (``kernels.lm_head_xent``)."""
    return {"lm_head_xent_fwd": n, "lm_head_xent_bwd": n}


NO_HEAD = head_launches(0)
# phase 3's LM-head shapes (arch, tp, rank, tokens): the main path's head
# and internlm2-1.8b's rank-1 shard at tp 2
HEAD_CASES = (("bert-large", 1, 0, MAIN_TOKENS),
              ("internlm2-1.8b", 2, 1, MAIN_TOKENS))
# tests/test_torch_lm_head_xent.py's tolerances: the statistics at f32
# rounding; dX of a bf16 x (three of the nine split products) and dW
# relative to their norms
HEAD_STAT_ATOL, HEAD_S_RTOL, HEAD_DX_REL, HEAD_DW_REL = 2e-5, 2e-5, 1e-4, 1e-5
EXPECTED_LAUNCHES = {"adam_step": 3, "ef_compress": 6, "decompress": 6,
                     "flash_attention": 0, "flash_attention_wgmma": 0,
                     "flash_attention_wide": 0, **head_launches(6)}
# phase 21: the main path's model with the selective recompute
DOTS_ARCH = "bert-large-dots"
# block sizes beside the main path's 4096 that ef_compress must take
# (multiples of 8 that are not multiples of 32, and one that is)
SMALL_BLOCKS = (8, 24, 40, 520)

# phase 6b: the optimizer family at the main path's full width and depth
FAMILY = dict(arch="bert-large", batch=16, seq=128, block_size=4096,
              seed=0)
FAMILY_SMALL_RECIPES = ("onebit_lamb", "zerone_adam_local")
# 0/1 Adam: within 3 + 5 steps, sync at compressed steps 0, 1, 2, 4, a 0-bit
# step at 3, v refreshed at counts 4, 6 and 8
ZERONE = dict(var_update_interval=2, sync_double_every=2,
              sync_max_interval=2)
ZERONE_STEPS = (3, 5)
NO_FLASH = {"flash_attention": 0, "flash_attention_wgmma": 0,
            "flash_attention_wide": 0}
FAMILY_LAUNCHES = {
    "onebit_lamb": {"adam_step": 0, "ef_compress": 6, "decompress": 6,
                    **head_launches(6)},
    "zerone_adam_local": {"adam_step": 3, "ef_compress": 8,
                          "decompress": 8, **head_launches(8)},
    "onebit_adam_topk": {"adam_step": 3, "ef_compress": 0, "decompress": 0,
                         **head_launches(6)},
    # two microbatches a step
    "zero1_accum": {"adam_step": 3, "ef_compress": 6, "decompress": 6,
                    **head_launches(12)},
    # the resumed run: steps 4 and 5, both compressed
    "resume": {"adam_step": 0, "ef_compress": 4, "decompress": 4,
               **head_launches(2)},
}
# the accumulated run's warmup losses against phase 5's: the microbatch
# means weight the masked tokens per microbatch, the full batch per token
# (tests/test_torch_family_slice.py::test_accum_steps_against_full_batch
# fixes this rtol on the CPU, where it measured up to 3.6e-4)
ACCUM_LOSS_RTOL = 1e-3

# phase 6c: the main path with the bucketed pipelined exchange and backward
# overlap; 2 ef_compress and 2 decompress launches a bucket and compressed
# step (no collective on one card: worker and server EF, both decompresses)
PIPE_BUCKETS = 4
PIPE_UNITS = (22251, 22251, 22251, 22252)
PIPE_LAUNCHES = {"adam_step": 3, "ef_compress": 24, "decompress": 24,
                 "flash_attention": 0, "flash_attention_wgmma": 0,
                 "flash_attention_wide": 0, **head_launches(6)}
PIPE = dict(pipeline=PIPE_BUCKETS, overlap_bwd="on")
# buckets 0-2 hold stacked block leaves whose layer-0 slices land before the
# embedding's gradient; bucket 3 holds the embedding and issues last
PIPE_EARLY = PIPE_BUCKETS - 1
# the state phase 6c is held to, bitwise
PIPE_STATE = ("m", "worker_err", "server_err")

# phase 11: the functional oracles against the registry optimizer at the
# family's full BERT-Large (3 warmup + 3 compressed steps, then one zero1
# step); launches of the oracle's own updates
ORACLE_STEPS = (3, 3)
ORACLE_LAUNCHES = {"adam_step": 0, "ef_compress": 6, "decompress": 6}
ORACLE_ZERO1_LAUNCHES = {"adam_step": 0, "ef_compress": 2, "decompress": 2}
# warmup: the fused kernel squares g as (1-b2)*g*g, the oracle as the
# reference does, (1-b2)*square(g); each output is held at this rtol of
# the size of the terms it is formed from
ORACLE_WARM_RTOL = 1e-6

# phase 12: the claim benchmarks; the variance system phase once more at
# full BERT-Large, at the BERT pre-training peak LR (Devlin et al. 2019)
CLAIMS_SEGMENTS = 8
CLAIMS_SYSTEM = dict(arch="bert-large", batch=16, seq=128, block=4096,
                     steps=80, b2=0.97, lr=1e-4)

# phase 13: the main path with every schedule axis left to the plan tuner,
# priced on the paper's headline cluster and the card's calibrated spec
PLAN_RUN = dict(topology="auto", pipeline="auto", overlap_bwd="auto",
                cluster="ethernet-10g")
# a fitted rate above the data sheet's by more than this is a failed fit
PLAN_SHARE_MAX = 1.05

# phase 14: the main path with telemetry, the memory ledger and the audit
# on every compressed step (14a); the CLI with the pipelined exchange,
# backward overlap and a profile of the last two steps (14b)
OBS_RUN = dict(memory="on", audit="on", audit_every=1)
# phase 5's launches plus one ef_compress and one decompress an audited
# step (the probe's round trip of the compressed momentum) and the probe's
# own loss and backward through the LM head
OBS_LAUNCHES = dict(EXPECTED_LAUNCHES, ef_compress=9, decompress=9,
                    **head_launches(9))
OBS_CLI = ["--arch", "bert-large", "--steps", "6", "--warmup-steps", "3",
           "--batch", "16", "--seq", "128", "--pipeline", "4",
           "--overlap-bwd", "on", "--profile-steps", "2", "--memory", "on",
           "--bench", "obs_smoke"]
OBS_CLI_TIMEOUT_S = 600
# attributed + residual is the window by construction; in floating point
# the sum may miss it by rounding
OBS_WINDOW_ATOL_S = 1e-12

# phase 15: the model families.  15a: every new arch's reduced() config,
# and the MoE one under the gather dispatch, on the card and on the CPU
FAMILY_ARCHS = ("deepseek-7b-smoke", "falcon-mamba-7b-smoke",
                "granite-34b-smoke", "internvl2-2b-smoke",
                "jamba-1.5-large-398b-smoke",
                "llama4-scout-17b-a16e-smoke", "mixtral-8x22b-smoke",
                "musicgen-large-smoke", "mixtral-8x22b-smoke-gather")
FAMILIES_SMALL = dict(recipe="onebit_adam", steps=5, warmup_steps=3,
                      batch=4, seq=64, block_size=512, lr=2e-3, lr_warmup=2)
# 64 text tokens after the 16-patch prefix
FAMILIES_SEQ = {"internvl2-2b-smoke": 80}
FAMILIES_SMALL_LAUNCHES = dict(NO_FLASH, adam_step=3, ef_compress=4,
                               decompress=4, **head_launches(5))
# the first compressed payload's sign bits that may differ card/cpu from
# one state (tests/test_torch_slice.py's ceiling against the reference: a
# bit flips only where the local momentum lies within the rounding
# difference of zero).  From each side's own warmup the share was 3.7e-3
# on internvl2-2b-smoke on an H100: Adam's first steps turn the card's
# rounding of near-zero gradients into coordinates 1e-4 apart (13,369 of
# them there; the patches' N(0, 1) rows make its gradient 1.2e-4 of its
# largest entry apart at step 0, 5e-7 elsewhere).  Each flip moves its
# coordinate by 2 lr scale / sqrt(v), and at these sizes v is tiny on
# some coordinates, so the loss after the first compressed update can
# leave SMALL_LOSS_RTOL (6.2e-3 on granite-34b-smoke, a dense arch): it is
# reported, not held
FAMILIES_SIGN_FLIP_CEILING = 1e-3
# 15b: falcon-mamba-7b at its published widths, cut to 2 layers (two of
# its one-layer periods)
MAMBA_ARCH = "falcon-mamba-7b-2l"
MAMBA = dict(arch=MAMBA_ARCH, recipe="onebit_adam", steps=6,
             warmup_steps=3, batch=2, seq=2048, block_size=4096, seed=0)
MAMBA_LAUNCHES = dict(NO_FLASH, adam_step=3, ef_compress=6, decompress=6,
                      **head_launches(6))
# 15c: mixtral-8x22b's MoE layer alone at full width: f32 parameters from
# seed 0, bf16 inputs of batch 2 x seq 4096 (t = 8192, capacity 2560)
MOE_LAYER = dict(batch=2, seq=4096, seed=0)
MOE_LAYER_REPS = 3
# both dispatches move each token exactly and sum the experts' outputs
# in expert order; the output and the input gradient are bf16, so they
# are held at one bf16 ulp (2^-7 relative)
MOE_LAYER_TOL = dict(rtol=2 ** -7, atol=1e-6)

# phase 16: the rest of serving.  16a: every decoding family beyond the
# dense token decoders, reduced() and in f32 with attn_impl="pallas", card
# against CPU as phase 8 (the prompt passes mixtral-smoke's window of 64)
SERVE_FAMILY_ARCHS = ("mixtral-8x22b-smoke", "mixtral-8x22b-smoke-gather",
                      "llama4-scout-17b-a16e-smoke", "falcon-mamba-7b-smoke",
                      "jamba-1.5-large-398b-smoke", "internvl2-2b-smoke",
                      "musicgen-large-smoke")
SERVE_FAMILY = dict(batch=2, prompt=72, steps=8, seed=0)
# 16b: falcon-mamba-7b at its published width and depth through
# ServeEngine.generate, as phase 9 serves llama3.2-3b
SERVE_MAMBA = dict(arch="falcon-mamba-7b", batch=8, prompt=2048,
                   new_tokens=32, seed=0)
# 16c: mixtral-8x22b at full width cut to 2 layers, bf16, the flash kernel
# (prompts past the window of 4096: the prefill seeds the ring buffer and
# the kernel takes its windowed route)
MIXTRAL_ARCH = "mixtral-8x22b-2l"
SERVE_MIXTRAL = dict(arch=MIXTRAL_ARCH, batch=2, prompt=5120, new_tokens=16,
                     seed=0)
# the kernel on its serving inputs (layer 0's q, k, v: (2, 48, 5120, 128)
# bf16, window 4096) is held to its plain version at FLASH_BF16_TOL.  End
# to end the bf16 logits of the flash route and of attn_impl="full" are
# two roundings of one f32 function: each attention output rounds to bf16
# once, and the two roundings differ by an ulp in a share of the outputs
# (0.26 % of the hidden state after layer 0 in a bf16 mixtral of d 1024
# on the CPU, the kernel's plain version against "full"), which the MoE
# layers carry to 1.6 % after two layers; so they are not held to each
# other at the 16-bit flash tolerance (reported: SERVE_MIXTRAL_TOL).
# Each is held instead against the same model in f32 (the engine's bf16
# weights in f32, attn_impl="full", TF32 off): the flash route's largest
# error at most SERVE_MIXTRAL_ERR_RATIO times the full route's (0.98-1.0
# on the CPU with the plain version), unless a token routes to another
# expert between the runs (then reported, as in 16a)
SERVE_MIXTRAL_TOL = dict(rtol=2e-2, atol=5e-3)
SERVE_MIXTRAL_ERR_RATIO = 1.5
# phase 17: the paper's ResNet (Sec. 7.2) and DCGAN (Sec. 7.3) claims and
# the benchmark harness.  17a: the reference-size nets card against CPU,
# 4 onebit steps with T_w 2; the losses of the warmup steps 0-1 (and the
# one after them, taken before any compressed update) within
# SMALL_LOSS_RTOL (cuDNN's convs and the CPU's sum in other orders; Adam's
# first step turns ULP differences of near-zero gradients into update
# differences); the first compressed payload's sign bits at most
# FAMILIES_SIGN_FLIP_CEILING apart, from the CPU's state (phase 15a's
# rule, for its reason)
VISION_SMALL = dict(steps=4, warmup=2)
# 17b: the harness entries on the card; each launches both 1-bit kernels
VISION_CLAIMS = ("resnet_convergence", "dcgan_convergence", "kernel_micro")
# 17c: the paper's CIFAR shape, ResNet-18's stage widths at 32 x 32 (the
# reference's net keeps one block a stage), batch 128, 150 steps, T_w 40.
# Adam stays finite; 1-bit Adam's loss is non-finite from step 43 on: the
# weights of ReLU channels dead through the warmup end it with v = 0, and
# the first compressed update moves them by lr * m_bar / eps (the
# reference does the same at this shape, tests/torch_cifar_divergence.py)
VISION_CIFAR = dict(widths=(64, 128, 256, 512), size=32, batch=128,
                    steps=150, onebit_nonfinite_at=43)
VISION_BUDGET_S = 60.0
SERVE = dict(arch="llama3.2-3b", batch=8, prompt=2048, new_tokens=32,
             seed=0)
SERVE_SMALL = dict(arch="llama3.2-3b-smoke", batch=2, prompt=64, steps=8,
                   seed=0)
# f32 on both sides (TF32 off); cuBLAS and the CPU BLAS, and the kernel's
# online softmax and the plain one, sum in other orders: the tolerance of
# tests/test_kernels.py's prefill test
SERVE_SMALL_TOL = dict(rtol=1e-4, atol=1e-4)
# phase 9b: the f32 prefill at full width through the same entry point
SERVE_F32 = dict(arch="llama3.2-3b", batch=8, prompt=2048, new_tokens=4,
                 seed=0)
# its last-position logits against attn_impl="full" on the card: f32 on
# both sides (TF32 off); the f32 route's online softmax and the full path's
# one softmax sum in other orders, as in phase 8, so the same tolerance
# (tests/test_kernels.py's prefill test), now over 28 full-width layers
SERVE_F32_TOL = dict(rtol=1e-4, atol=1e-4)
# every 16-bit check: the rtol of tests/test_kernels.py:176; the
# tensor-core kernel also rounds p to bf16 (relative 2^-8) before p v, the
# plain version keeps it in f32. The least atol that passes at this rtol
# reads 2.9e-3 at the serving shape (bf16, where 71 % of outputs have
# |o| < 1/16) and at most 1.5e-3 in the other bf16 and fp16 cases, on an
# H100; that test's atol of 2e-2 would be a third of the 1/16 under which
# most outputs lie here
FLASH_BF16_TOL = dict(rtol=2e-2, atol=5e-3)
FLASH_F32_TOL = dict(rtol=1e-5, atol=2e-6)
# head dims above 256 in f32: the scores sum up to 1024 products (256 in the
# other f32 checks), so their rounding, and the outputs', grows with D; an
# H100 read a max abs err of 4.9e-6 at D = 1000 (the SIMT kernel this route
# had before).  16-bit: the wide route keeps p to 16 bits or more (two terms
# of the input dtype) and the accumulator in f32, as the plain version keeps
# p and o in f32, and rounds only the output, so the two differ by at most
# about an output ulp: ulp/|o| is at most 2^-7 (bf16) or 2^-10 (fp16), hence
# rtol 8e-3 and 1e-3; atol 1e-5 covers outputs near zero (fp16 subnormals
# below 6.1e-5)
FLASH_WIDE_TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
                  torch.bfloat16: dict(rtol=8e-3, atol=1e-5),
                  torch.float16: dict(rtol=1e-3, atol=1e-5)}
FLASH_WIDE_DIMS = (320, 512, 1000)
# the wide route timed on one shape (no configuration has D > 128)
FLASH_WIDE_TIMED = (2, 8, 1024, 512)
# the f32 route and the wgmma kernel timed at the serving shape
FLASH_SERVE_SHAPE = (8, 24, 2048, 128)
# the split kernel's symbol in the library's SASS
SPLIT_KERNEL = "flash_fwd_split_kernel"
# at the serving shape the share of outputs bitwise the plain version's
# must stay above this: a kernel wrong in a minority of rows, where the
# outputs are small, would pass the tolerance alone
FLASH_BITWISE_FLOOR = 0.5
# |o| under this counts as a small output in the readings
FLASH_SMALL_O = 1 / 16


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def atol_needed(got: torch.Tensor, want: torch.Tensor, rtol: float) -> float:
    """The least atol at which ``got`` is close to ``want`` at ``rtol``."""
    g, w = got.float(), want.float()
    return max(0.0, float(((g - w).abs() - rtol * w.abs()).max()))


def phase_build() -> float:
    from repro_torch.kernels import build
    t0 = time.time()
    lib = build.build(verbose=True)
    build.load()
    secs = time.time() - t0
    log(f"[build] {lib} in {secs:.1f} s")
    return secs


def phase_kernels(d: int, block: int, seed: int = 0):
    """Each kernel against its plain version at (d,) f32, block ``block``;
    returns the kernel entries of the JSON line (launches filled later)."""
    from repro_torch.kernels.fused_adam import kernel as FK
    from repro_torch.kernels.fused_adam import ref as FR
    from repro_torch.kernels.onebit import kernel as OK
    from repro_torch.kernels.onebit import ref as OR
    from repro_torch.perf.device import kernel_bound
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(scale=1.0):
        return torch.randn(d, generator=gen, device=dev) * scale

    entries = []
    for blk in SMALL_BLOCKS:
        xs = torch.randn(64 * blk, generator=gen, device=dev)
        es = torch.randn(64 * blk, generator=gen, device=dev) * 0.1
        got, want = (OK.ef_compress_fused(xs, es, blk),
                     OR.ef_compress_fused(xs, es, blk))
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"ef_compress block {blk}: packed is not "
                                 "bitwise the plain version")
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)
        torch.testing.assert_close(got[2], want[2], rtol=1e-5, atol=1e-6)
    log(f"[kernels] ef_compress at blocks {SMALL_BLOCKS}: packed bitwise")
    x, err = randn(), randn(0.1)
    pk, sc, ne = OK.ef_compress_fused(x, err, block)
    pk_r, sc_r, ne_r = OR.ef_compress_fused(x, err, block)
    torch.cuda.synchronize()
    if not torch.equal(pk, pk_r):
        n_bad = int((pk != pk_r).sum())
        raise AssertionError(f"ef_compress: packed differs in {n_bad} bytes")
    torch.testing.assert_close(sc, sc_r, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(ne, ne_r, rtol=1e-5, atol=1e-6)
    err_max = max(float((sc - sc_r).abs().max()),
                  float((ne - ne_r).abs().max()))
    del pk, sc, ne, ne_r
    ms = time_ms(lambda: OK.ef_compress_fused(x, err, block))
    plain = time_ms(lambda: OR.ef_compress_fused(x, err, block))
    b_ms, b_by = kernel_bound(12 * d + d / 8 + 4 * d / block, 5 * d)
    entries.append(dict(
        name="ef_compress", route="cuda",
        source="src/repro_torch/csrc/onebit.cu",
        replaces="src/repro/kernels/onebit/kernel.py:59", ok=True,
        max_abs_err=err_max, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, launches_per_step=2))
    log(f"[kernels] ef_compress ok: {ms:.3f} ms (plain {plain:.3f} ms, "
        f"bound {b_ms:.3f} ms), max abs err {err_max:.3e}")
    del x, err

    out = OK.decompress(pk_r, sc_r, block)
    out_r = OR.decompress(pk_r, sc_r, block)
    if not torch.equal(out, out_r):
        raise AssertionError("decompress: output is not bitwise the plain "
                             "version")
    del out, out_r
    ms = time_ms(lambda: OK.decompress(pk_r, sc_r, block))
    plain = time_ms(lambda: OR.decompress(pk_r, sc_r, block))
    b_ms, b_by = kernel_bound(4 * d + d / 8 + 4 * d / block, d)
    entries.append(dict(
        name="decompress", route="cuda",
        source="src/repro_torch/csrc/onebit.cu",
        replaces="src/repro/kernels/onebit/kernel.py:95", ok=True,
        max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=None, launches_per_step=2))
    log(f"[kernels] decompress ok (bitwise): {ms:.3f} ms (plain "
        f"{plain:.3f} ms, bound {b_ms:.3f} ms)")
    del pk_r, sc_r
    torch.cuda.empty_cache()

    xa, m, g = randn(), randn(0.01), randn(0.01)
    v = randn(1e-4).abs()
    err_max = 0.0
    for wd in (0.0, 0.01):
        got = FK.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999, 1e-8, wd)
        want = FR.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999, 1e-8, wd)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=5e-7)
            err_max = max(err_max, float((a - b).abs().max()))
        del got, want
    ms = time_ms(lambda: FK.adam_step(xa, m, v, g, 1e-3))
    plain = time_ms(lambda: FR.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999,
                                         1e-8))
    # the library call: torch's fused AdamW divides by 1 - b^step; at step
    # 1e9, 0.9^step and 0.999^step are 0 in f32, so both corrections are
    # exactly 1 and it computes BertAdam (decoupled weight decay, applied
    # before the Adam term: the same update up to rounding).  It rounds in
    # another order than the kernel and the plain version (which share
    # theirs), so each output is held at the kernel's rtol 1e-5 / atol 5e-7
    # of the size of the terms it is formed from, not of its own: where v
    # is tiny, x - lr m / sqrt(v) cancels and its rounding is that of the
    # (large) update.  Then timed in place on copies
    step_t = torch.full((), 1e9, device=dev)

    def fused_adamw(xc, mc, vc, wd=0.0):
        torch._fused_adamw_([xc], [g], [mc], [vc], [], [step_t], lr=1e-3,
                            beta1=0.9, beta2=0.999, weight_decay=wd,
                            eps=1e-8, amsgrad=False, maximize=False)
        return xc, mc, vc

    lib_err = 0.0
    for wd in (0.0, 0.01):
        got = fused_adamw(xa.clone(), m.clone(), v.clone(), wd)
        want = FR.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999, 1e-8, wd)
        m_terms = 0.9 * m.abs() + 0.1 * g.abs()
        terms = (xa.abs() * (1 + 1e-3 * wd)
                 + 1e-3 * m_terms / (want[2].sqrt() + 1e-8),
                 m_terms, 0.999 * v + 0.001 * g * g)
        for name, a, b, t in zip(("x", "m", "v"), got, want, terms):
            err = (a - b).abs()
            n_bad = int((err > 5e-7 + 1e-5 * t).sum())
            if n_bad:
                raise AssertionError(
                    f"torch._fused_adamw_ (wd {wd}): {name} differs from "
                    f"the plain version in {n_bad} elements beyond rtol "
                    f"1e-5 of its terms, max abs err {float(err.max())}")
            lib_err = max(lib_err, float(err.max()))
            del err
        del got, want, m_terms, terms
    copies = (xa.clone(), m.clone(), v.clone())
    lib = time_ms(lambda: fused_adamw(*copies))
    del copies
    b_ms, b_by = kernel_bound(28 * d, 12 * d)
    entries.append(dict(
        name="adam_step", route="cuda",
        source="src/repro_torch/csrc/fused_adam.cu",
        replaces="src/repro/kernels/fused_adam/kernel.py:44", ok=True,
        max_abs_err=err_max, ms=ms, plain_ms=plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib, library_max_abs_err=lib_err,
        launches_per_step=1))
    log(f"[kernels] adam_step ok: {ms:.3f} ms (plain {plain:.3f} ms, "
        f"bound {b_ms:.3f} ms), max abs err {err_max:.3e}; "
        f"torch._fused_adamw_ at step 1e9 (bias corrections 1: the same "
        f"function) {lib:.3f} ms, max abs err against the plain version "
        f"{lib_err:.3e}")
    del xa, m, v, g
    torch.cuda.empty_cache()
    entries += phase_head_kernels(seed)
    return entries


def phase_head_kernels(seed: int = 0) -> list:
    """The LM head's kernels against their plain version at
    ``HEAD_CASES`` (m_l, s_l, ll_l, dX, dW at the unit test's tolerances),
    then timed at the main path's head; the two kernel entries."""
    from repro_torch.benchmarks import lm_head_bench
    from repro_torch.configs import get_config
    from repro_torch.kernels.lm_head_xent import kernel as K
    from repro_torch.kernels.lm_head_xent import ref as R
    dev = torch.device("cuda")

    def rel(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    errs = {}
    for arch, tp, rank, t in HEAD_CASES:
        cfg = get_config(arch)
        d, v_l = cfg.d_model, cfg.padded_vocab(tp) // tp
        off = rank * v_l
        gen = torch.Generator(device=dev).manual_seed(seed)
        x = torch.randn(t, d, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(d, v_l, generator=gen, device=dev) * 0.5 / d ** 0.5
        labels = torch.randint(0, cfg.vocab, (t,), generator=gen, device=dev)
        local = labels - off
        lab = torch.where((local >= 0) & (local < v_l), local, -1).int()
        n_keep = min(max(cfg.vocab - off, 0), v_l)
        a = torch.rand(t, generator=gen, device=dev) / t
        b = -torch.rand(t, generator=gen, device=dev) / t
        m, s, ll, saved = K.forward(x, w, lab, n_keep)
        m0, s0, ll0 = R.forward(x, w, lab, n_keep)
        torch.testing.assert_close(m, m0, rtol=0, atol=HEAD_STAT_ATOL)
        torch.testing.assert_close(s, s0, rtol=HEAD_S_RTOL, atol=0)
        torch.testing.assert_close(ll, ll0, rtol=0, atol=HEAD_STAT_ATOL)
        dx, dw = K.backward(saved, lab, n_keep, m, a, b, d)
        dx0, dw0 = R.backward(x, w, lab, n_keep, m0, a, b)
        e = dict(m=float((m - m0).abs().max()),
                 s_rel=float(((s - s0).abs() / s0).max()),
                 ll=float((ll - ll0).abs().max()), dx_rel=rel(dx, dx0),
                 dw_rel=rel(dw, dw0),
                 segments=K.segments(dev, t, v_l))
        if e["dx_rel"] >= HEAD_DX_REL or e["dw_rel"] >= HEAD_DW_REL:
            raise AssertionError(f"lm_head_xent {arch} tp {tp}: {e}")
        errs[f"{arch}.tp{tp}.rank{rank}"] = e
        log(f"[kernels] lm_head_xent at {arch}'s head (T {t}, d {d}, V_l "
            f"{v_l}, offset {off}, {e['segments']} vocab segments) against "
            f"the plain version: max |m| err {e['m']:.2e}, s rel "
            f"{e['s_rel']:.2e}, |ll| {e['ll']:.2e}, dX {e['dx_rel']:.2e}, "
            f"dW {e['dw_rel']:.2e} of the norm")
        del x, w, saved, dx, dw, dx0, dw0
        torch.cuda.empty_cache()
    _, _, _, t = HEAD_CASES[0]
    cfg = get_config(HEAD_CASES[0][0])
    r = lm_head_bench.run_case("main", t, cfg.d_model, cfg.padded_vocab(1),
                               cfg.vocab, seed)
    torch.cuda.empty_cache()
    entries = []
    for key, counter in (("fwd", "lm_head_xent_fwd"),
                         ("bwd", "lm_head_xent_bwd")):
        x = r[key]
        entries.append(dict(
            name=counter, route="cuda",
            source="src/repro_torch/csrc/lm_head_xent.cu", replaces=None,
            ok=True, max_abs_err=max(max(e["m"], e["ll"])
                                     for e in errs.values()),
            errs=errs, ms=x["ms"],
            plain_ms=x["plain_ms"], bound_ms=x["bound_ms"],
            bound_by=f"{x['bound_by']} at the TF32 rate",
            split_floor_ms=x["split_floor_ms"], library_ms=x["library_ms"],
            host_ms=r["host_ms"], library_host_ms=r["library_host_ms"],
            launches_per_step=1))
        log(f"[kernels] {counter} at the main path's head ok: {x['ms']:.3f} "
            f"ms (plain {x['plain_ms']:.3f} ms, the f32 torch path "
            f"{x['library_ms']:.3f} ms, bound {x['bound_ms']:.3f} ms by "
            f"{x['bound_by']} at the TF32 rate, the split's floor "
            f"{x['split_floor_ms']:.3f} ms)")
    log(f"[kernels] lm_head_xent host ms a loss and its backward: "
        f"{r['host_ms']:.3f} (the f32 torch path {r['library_host_ms']:.3f})")
    return entries


def phase_small() -> None:
    """The port's run on the card and on the CPU from one seed agree."""
    from repro_torch.launch.train import run
    card = run(device="cuda", **SMALL)["history"]
    cpu = run(device="cpu", **SMALL)["history"]
    for a, b in zip(card, cpu):
        if a["stage"] != b["stage"] or not math.isfinite(a["loss"]):
            raise AssertionError(f"small run: step {a} vs cpu {b}")
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        if rel > SMALL_LOSS_RTOL:
            raise AssertionError(f"small run step {a['step']}: loss "
                                 f"{a['loss']} on the card vs {b['loss']} "
                                 f"on the CPU (rel {rel:.2e})")
    log("[small] card vs cpu losses: " + ", ".join(
        f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b in zip(card, cpu)))


def phase_main():
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = run(device="cuda", **MAIN)
    counts = build.launch_counts()
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    stages = [h["stage"] for h in hist]
    w = MAIN["warmup_steps"]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite losses {losses}")
    if stages != ["warmup"] * w + ["compressed"] * (MAIN["steps"] - w):
        raise AssertionError(f"stage did not flip at step {w}: {stages}")
    v_l1 = [h["v_l1"] for h in hist[w - 1:]]
    if len(set(v_l1)) != 1:
        raise AssertionError(f"v changed in the compressed stage: {v_l1}")
    if counts != EXPECTED_LAUNCHES or res["launches"] != counts:
        raise AssertionError(f"launch counts {counts} (run says "
                             f"{res['launches']}), expected "
                             f"{EXPECTED_LAUNCHES}")
    tokens = MAIN["batch"] * MAIN["seq"]
    warm_ms = [h["ms"] for h in hist[:w]]
    comp_ms = [h["ms"] for h in hist[w:]]
    steady = sorted(comp_ms)[len(comp_ms) // 2]
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] d={res['d']} d_pad={res['d_pad']} losses "
        + ", ".join(f"{x:.4f}" for x in losses))
    log(f"[main] warmup step ms {warm_ms}, compressed step ms {comp_ms}, "
        f"tokens/s {tokens / (steady / 1e3):.1f} (median compressed step), "
        f"peak memory {peak} bytes")
    return counts, dict(warmup_step_ms=warm_ms, compressed_step_ms=comp_ms,
                        tokens_per_s=tokens / (steady / 1e3),
                        peak_bytes=peak, losses=losses), res["state"]


def phase_family_small() -> None:
    """``bert-large-smoke`` on the card and on the CPU from one seed under
    the recipes of the family's new layouts: the losses agree as phase 4's
    do for 1-bit Adam."""
    from repro_torch.launch.train import run
    for recipe in FAMILY_SMALL_RECIPES:
        kw = dict(SMALL, recipe=recipe)
        card = run(device="cuda", **kw)
        cpu = run(device="cpu", **kw)
        if card["layout"] != cpu["layout"]:
            raise AssertionError(f"{recipe}: layouts {card['layout']} / "
                                 f"{cpu['layout']}")
        for a, b in zip(card["history"], cpu["history"]):
            rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
            if (a["stage"], a["sync"]) != (b["stage"], b["sync"]) \
                    or not math.isfinite(a["loss"]) or rel > SMALL_LOSS_RTOL:
                raise AssertionError(f"family small {recipe}: step {a} on "
                                     f"the card vs {b} on the CPU")
        log(f"[family-small] {recipe} ({card['layout']} layout) card vs cpu "
            "losses: " + ", ".join(f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b
                                   in zip(card["history"], cpu["history"])))


def _family_stream():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    cfg = get_config(FAMILY["arch"])
    return cfg, SyntheticStream(
        cfg, InputShape("family", FAMILY["seq"], FAMILY["batch"], "train"),
        seed=FAMILY["seed"], device="cuda")


def _family_state(optimizer, layout: str = "replicated"):
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import init_train_state
    cfg, stream = _family_stream()
    params = init_params(cfg, torch.Generator().manual_seed(FAMILY["seed"]),
                         "cuda")
    ts = init_train_state(cfg, params, optimizer, FAMILY["block_size"], 1,
                          "cuda", layout=layout)
    return ts, stream


def _timed_step(ts, optimizer, batch, step, stage, **kw) -> dict:
    """One train_step with the main path's lr schedule; the step's record
    (wall ms to the host fetch of its metrics, launches it made)."""
    from repro_torch.kernels import build
    from repro_torch.launch.train import lr_schedule
    from repro_torch.train.step import train_step
    before = build.launch_counts()
    t0 = time.perf_counter()
    m = train_step(ts, optimizer, batch, lr_schedule(step, 1e-3, 20), stage,
                   **kw)
    host = {k: float(v) for k, v in m.items()}
    ms = (time.perf_counter() - t0) * 1e3
    after = build.launch_counts()
    return {"step": step, "stage": stage, "sync": kw.get("sync", True),
            "ms": ms, **host,
            "launched": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}


def _family_run(tag: str, fn) -> dict:
    """Run ``fn`` (-> history) with the launch counts set to 0 just before
    and read just after; check them, the losses and log every step."""
    from repro_torch.kernels import build
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    hist = fn()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict(FAMILY_LAUNCHES[tag], **NO_FLASH)
    if counts != want:
        raise AssertionError(f"family {tag}: launch counts {counts}, "
                             f"expected {want}")
    if not all(math.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"family {tag}: non-finite losses {hist}")
    for h in hist:
        log(f"[family] {tag} step {h['step']} [{h['stage']}"
            f"{'' if h.get('sync', True) else ' 0-bit'}] loss "
            f"{h['loss']:.6f} {h['ms']:.1f} ms")
    log(f"[family] {tag}: peak memory {peak} bytes, launches {counts}, "
        f"{wall:.1f} s with set-up")
    return dict(step_ms=[h["ms"] for h in hist],
                stages=[h["stage"] for h in hist],
                syncs=[h.get("sync", True) for h in hist],
                losses=[h["loss"] for h in hist], peak_bytes=peak,
                launches=counts, wall_s=wall)


def _run_hist(**kw):
    from repro_torch.launch.train import run
    return run(device="cuda", verbose=False,
               **{**FAMILY, "steps": 6, "warmup_steps": 3, **kw})


def _resume(stats: dict) -> None:
    """Checkpoint resume of 1-bit LAMB at full width: two uninterrupted
    6-step runs (their spread), a 4-step run that saves, the bitwise round
    trip of that checkpoint, and the resumed run to step 6."""
    from repro_torch.configs import get_config
    from repro_torch.convert import flat_from_params, params_from_flat
    from repro_torch.launch.train import run
    from repro_torch.models.transformer import leaf_shapes
    from repro_torch.state import flat_layout, state_bytes
    from repro_torch.state.checkpoint import load_train_state
    from repro_torch.train.step import flat_dim, segment_info
    cfg = get_config(FAMILY["arch"])
    d_pad = flat_dim(cfg, 1, FAMILY["block_size"])
    full = _run_hist(recipe="onebit_lamb")
    slots = full["optimizer"].state_slots(full["layout"])
    ctx = flat_layout(d_pad, 1, segment_info(cfg, d_pad).n)
    need = 4 * full["d"] + state_bytes(slots, ctx)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(tmp).free
        log(f"[family] resume: the checkpoint will take ~{need} bytes; "
            f"{free} bytes free under {tmp}")
        if free < 2 * need:
            raise SystemExit(f"chip_smoke: {free} bytes free under {tmp}, "
                             f"less than twice the {need}-byte checkpoint")
        path = os.path.join(tmp, "lamb.npz")
        second = _run_hist(recipe="onebit_lamb")
        a, b = full["state"], second["state"]
        same = torch.equal(a.x, b.x) and all(
            torch.equal(a.opt[k], b.opt[k]) for k in a.opt) and \
            [h["loss"] for h in full["history"]] == \
            [h["loss"] for h in second["history"]]
        spread_x = float((a.x - b.x).abs().max())
        spread_loss = max(abs(p["loss"] - q["loss"]) / abs(p["loss"]) for
                          p, q in zip(full["history"], second["history"]))
        del second, b
        culprit = []
        if not same:
            # name the op that makes two runs differ
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    _run_hist(recipe="onebit_lamb", steps=1)
                finally:
                    torch.use_deterministic_algorithms(False)
            culprit = sorted({str(w.message)[:200] for w in caught})
        log(f"[family] resume: two uninterrupted runs bitwise equal: {same} "
            f"(max |dx| {spread_x:.3e}, loss rel {spread_loss:.3e})"
            + (f"; nondeterministic ops: {culprit}" if culprit else ""))

        first = run(device="cuda", verbose=False, recipe="onebit_lamb",
                    ckpt=path, **dict(FAMILY, steps=4, warmup_steps=3))
        size = os.path.getsize(path)
        save_s = first["checkpoint_s"]["save"]
        ts1 = first["state"]
        (params, state), step = load_train_state(
            path, params_from_flat(ts1.x, leaf_shapes(cfg)), ts1.opt,
            slots=slots, ctx=ctx, n_buckets=1, block=FAMILY["block_size"])
        x_back = flat_from_params(params).to("cuda")
        round_trip = step == 4 and torch.equal(x_back, ts1.x[:ts1.d]) and \
            all(torch.equal(state[k], ts1.opt[k]) for k in ts1.opt)
        if not round_trip:
            raise AssertionError("family resume: the checkpoint does not "
                                 "load back bitwise")
        del params, state, x_back, first, ts1
        torch.cuda.empty_cache()

        resumed = {}

        def resumed_run():
            resumed.update(run(device="cuda", verbose=False,
                               recipe="onebit_lamb", resume=path,
                               **dict(FAMILY, steps=6, warmup_steps=3)))
            return resumed["history"]

        stats["resume"] = _family_run("resume", resumed_run)
        r = resumed["state"]
        want = [h["loss"] for h in full["history"][4:]]
        got = [h["loss"] for h in resumed["history"]]
        dx = float((r.x - a.x).abs().max())
        dloss = max(abs(p - q) / abs(q) for p, q in zip(got, want))
        bitwise = got == want and torch.equal(r.x, a.x) and all(
            torch.equal(r.opt[k], a.opt[k]) for k in a.opt)
        if same and not bitwise:
            raise AssertionError(f"family resume: not bitwise the "
                                 f"uninterrupted run (max |dx| {dx:.3e}, "
                                 f"losses {got} vs {want})")
        if not same and (dx > 2 * spread_x or dloss > 2 * spread_loss):
            raise AssertionError(f"family resume: max |dx| {dx:.3e}, loss "
                                 f"rel {dloss:.3e}, outside twice the spread "
                                 f"of two uninterrupted runs")
        cs = resumed["checkpoint_s"]
        stats["resume"].update(
            checkpoint_bytes=size, save_s=save_s,
            load_s=cs["load"], round_trip_bitwise=round_trip,
            resume_bitwise=bitwise, two_runs_bitwise=same,
            spread_max_abs_x=spread_x, spread_loss_rel=spread_loss,
            nondeterministic_ops=culprit)
        log(f"[family] resume: checkpoint {size} bytes, saved in "
            f"{save_s:.1f} s, loaded in {cs['load']:.1f} "
            f"s; round trip bitwise; steps 4-5 losses {got} (uninterrupted "
            f"{want}); resume bitwise: {bitwise}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_family(main_losses) -> dict:
    """The five family runs at full BERT-Large width and depth; each one's
    launch counts set to 0 before and checked after it."""
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import seed_zero1
    block = {"block_size": FAMILY["block_size"]}
    stats = {}

    def lamb():
        res = _run_hist(recipe="onebit_lamb")
        scale = res["state"].opt.scale
        if not bool((scale > 0).all()):
            raise AssertionError("onebit_lamb: trust ratios not frozen")
        return res["history"]

    stats["onebit_lamb"] = _family_run("onebit_lamb", lamb)

    def zerone():
        opt = get_optimizer("zerone_adam", compressor="onebit",
                            compressor_kwargs=block, **ZERONE)
        ts, stream = _family_state(opt, "local")
        hist, (w, c) = [], ZERONE_STEPS
        for step in range(w + c):
            stage = "warmup" if step < w else "compressed"
            sync = stage == "warmup" or opt.sync_due(step - w)
            rec = _timed_step(ts, opt, stream.batch_at(step), step, stage,
                              sync=sync)
            moved = rec["launched"].get("ef_compress", 0) + \
                rec["launched"].get("decompress", 0)
            if not sync and moved:
                raise AssertionError(f"0/1 Adam: 0-bit step {step} launched "
                                     f"{rec['launched']}")
            hist.append(rec)
        if [h["sync"] for h in hist[w:]] != [True, True, True, False, True]:
            raise AssertionError(f"0/1 Adam sync schedule {hist}")
        if int(ts.opt.v_step) != 8:
            raise AssertionError(f"0/1 Adam: v last refreshed at count "
                                 f"{int(ts.opt.v_step)}, expected 8")
        return hist

    stats["zerone_adam_local"] = _family_run("zerone_adam_local", zerone)

    def topk():
        return _run_hist(recipe="onebit_adam_topk")["history"]

    stats["onebit_adam_topk"] = _family_run("onebit_adam_topk", topk)

    def zero1_accum():
        opt = get_optimizer("onebit_adam", compressor="onebit",
                            compressor_kwargs=block)
        ts, stream = _family_state(opt)
        hist = [_timed_step(ts, opt, stream.batch_at(step), step, "warmup",
                            accum_steps=2) for step in range(3)]
        seed_zero1(ts, opt)
        hist += [_timed_step(ts, opt, stream.batch_at(step), step,
                             "compressed", accum_steps=2)
                 for step in range(3, 6)]
        if ts.layout != "zero1" or "master_shard" not in ts.opt:
            raise AssertionError("zero1 run did not run under zero1")
        return hist

    stats["zero1_accum"] = _family_run("zero1_accum", zero1_accum)
    got = stats["zero1_accum"]["losses"][:3]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, main_losses[:3])]
    stats["zero1_accum"]["warmup_loss_rel_to_main"] = rel
    log(f"[family] zero1_accum warmup losses {got} vs phase 5's "
        f"{main_losses[:3]}: rel {rel} (rtol {ACCUM_LOSS_RTOL})")
    if max(rel) > ACCUM_LOSS_RTOL:
        raise AssertionError("zero1_accum: warmup losses off phase 5's")

    _resume(stats)
    return stats


def phase_pipeline_small() -> None:
    """``bert-large-smoke`` with the pipelined exchange and backward
    overlap on the card and on the CPU from one seed: losses agree as
    phase 4's do; on the card the run is bitwise the serial one."""
    from repro_torch.launch.train import run
    card = run(device="cuda", **SMALL, **PIPE)
    cpu = run(device="cpu", **SMALL, **PIPE)
    serial = run(device="cuda", **SMALL)
    for res in (card, cpu):
        if res["n_buckets"] != PIPE_BUCKETS or not any(
                h["overlap"] for h in res["history"]):
            raise AssertionError(f"pipeline small: {res['plan']}, overlap "
                                 f"{[h['overlap'] for h in res['history']]}")
    for a, b in zip(card["history"], cpu["history"]):
        rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
        if a["stage"] != b["stage"] or not math.isfinite(a["loss"]) \
                or rel > SMALL_LOSS_RTOL:
            raise AssertionError(f"pipeline small: step {a} on the card vs "
                                 f"{b} on the CPU")
    got = [h["loss"] for h in card["history"]]
    want = [h["loss"] for h in serial["history"]]
    if got != want or not torch.equal(card["state"].x, serial["state"].x):
        raise AssertionError(f"pipeline small: card losses {got} not "
                             f"bitwise the serial run's {want}")
    log(f"[pipeline-small] {card['plan']}: card vs cpu losses "
        + ", ".join(f"{a['loss']:.6f}/{b['loss']:.6f}" for a, b in
                    zip(card["history"], cpu["history"]))
        + "; card bitwise the serial run")


def phase_pipeline(main_losses, main_state) -> dict:
    """Phase 6c: the main path with 4 buckets and backward overlap, held
    bitwise to phase 5's run; launch counts, peak memory, one profiled
    compressed step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    from repro_torch.state import bucket_sizes_for
    from repro_torch.train.step import train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = run(device="cuda", **MAIN, **PIPE)
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    w = MAIN["warmup_steps"]
    sizes = bucket_sizes_for(res["d_pad"], 1, MAIN["block_size"],
                             PIPE_BUCKETS)
    if tuple(s // MAIN["block_size"] for s in sizes) != PIPE_UNITS:
        raise AssertionError(f"bucket sizes {sizes}")
    if res["plan"] != f"pipe(flat/onebit)x{PIPE_BUCKETS}" or \
            [h["overlap"] for h in hist] != [False] * w + [True] * (
                MAIN["steps"] - w):
        raise AssertionError(f"pipeline: plan {res['plan']}, overlap "
                             f"{[h['overlap'] for h in hist]}")
    # stage 0s issued before backward's last gradient (the embedding's)
    # landed: every bucket but the embedding's, issued last
    early = [h["stage0_in_bwd"] for h in hist]
    if early != [0] * w + [PIPE_EARLY] * (MAIN["steps"] - w):
        raise AssertionError(f"pipeline: stage 0s issued inside backward "
                             f"{early}, expected {PIPE_EARLY} a compressed "
                             "step")
    log(f"[pipeline] stage 0s issued inside backward a step: {early}")
    if counts != PIPE_LAUNCHES or res["launches"] != counts:
        raise AssertionError(f"pipeline: launch counts {counts}, expected "
                             f"{PIPE_LAUNCHES}")
    losses = [h["loss"] for h in hist]
    ts = res["state"]
    same = {"losses": losses == main_losses,
            "x": torch.equal(ts.x.cpu(), main_state["x"])}
    for k in PIPE_STATE:
        same[k] = torch.equal(ts.opt[k].cpu(), main_state[k])
    log(f"[pipeline] {res['plan']} overlap on: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; bitwise phase 5's: {same}")
    if not all(same.values()):
        raise AssertionError(f"pipeline: not bitwise phase 5's run {same}")
    comp_ms = [h["ms"] for h in hist[w:]]
    log(f"[pipeline] warmup step ms {[h['ms'] for h in hist[:w]]}, "
        f"compressed step ms {comp_ms}, peak memory {peak} bytes")

    cfg = get_config(MAIN["arch"])
    stream = SyntheticStream(
        cfg, InputShape("profile", MAIN["seq"], MAIN["batch"], "train"),
        seed=1, device="cuda")
    batch = stream.batch_at(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(ts, res["optimizer"], batch, 1e-4, "compressed",
                   n_buckets=PIPE_BUCKETS, overlap_bwd=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_stats = _device_breakdown(prof, wall_ms)
    _log_breakdown("pipeline-profile", "compressed", prof_stats)
    del ts, res
    torch.cuda.empty_cache()
    return dict(step_ms=[h["ms"] for h in hist], losses=losses,
                peak_bytes=peak, launches=counts, bucket_sizes=list(sizes),
                stage0_in_bwd=early, bitwise_main=same, profile=prof_stats)


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd" in low:
        return "flash attention (csrc)"
    if any(k in low for k in ("ef_compress_kernel", "decompress_kernel",
                              "adam_kernel")):
        return "port kernels (csrc)"
    if any(k in low for k in ("gemm", "xmma", "cutlass", "sm90_", "nvjet")):
        return "matmul (cuBLAS)"
    if "reduce" in low:
        return "reductions"
    return "elementwise and other"


def _device_breakdown(prof, wall_ms: float) -> dict:
    """Device time by kernel group and by name, and the device's idle
    share of ``wall_ms``, from one torch.profiler trace."""
    from torch.autograd import DeviceType
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_group, n_group = {}, {}, {}
    for e in kernels:
        ms = e.time_range.elapsed_us() / 1e3
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
        g = _kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + ms
        n_group[g] = n_group.get(g, 0) + 1
    busy = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    dtod = sum(ms for n, ms in by_name.items()
               if n.lower().startswith("memcpy dtod"))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": (1.0 - busy / wall_ms) if busy else None,
            "n_kernels": len(kernels), "by_group_ms": by_group,
            "by_group_kernels": n_group,
            "memcpy_dtod_ms": dtod,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def _log_breakdown(tag: str, what: str, r: dict) -> None:
    log(f"[{tag}] {what}: wall {r['wall_ms']:.1f} ms, device busy "
        f"{r['device_busy_ms']:.1f} ms over {r['n_kernels']} kernels "
        f"(Memcpy DtoD {r['memcpy_dtod_ms']:.2f} ms); "
        + ", ".join(f"{g} {ms:.1f} ms"
                    for g, ms in sorted(r["by_group_ms"].items())))


def phase_profile(state) -> dict:
    """One warmup-stage and one compressed-stage step of the main path's
    model and state under torch.profiler, after the untraced run: device
    time by kernel group, the top kernels, and the device's idle share of
    the step's wall time.  A measurement, not a gate."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.optim import get_optimizer
    from repro_torch.train.step import train_step
    cfg = get_config(MAIN["arch"])
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size": MAIN["block_size"]})
    stream = SyntheticStream(
        cfg, InputShape("profile", MAIN["seq"], MAIN["batch"], "train"),
        seed=1, device="cuda")
    out = {}
    for i, stage in enumerate(("warmup", "compressed")):
        batch = stream.batch_at(i)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            train_step(state, opt, batch, 1e-4, stage)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out[stage] = _device_breakdown(prof, wall_ms)
        _log_breakdown("profile", stage, out[stage])
    return out


def _hgmma_by_kernel(lib_path, symbol: str) -> dict:
    """HGMMA instructions in the SASS of each instance of kernel ``symbol``
    in the built library: ``cuobjdump -sass`` split at each function's own
    header."""
    from repro_torch.kernels import build
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            if symbol in name:
                out[name] = 0
        elif name in out and "HGMMA" in line:
            out[name] += 1
    return out


def phase_flash(seed: int = 0):
    """The three flash-attention routes against their plain version: small
    f32 shapes (the f32 route) at tests/test_kernels.py's tolerance, ragged
    fp16 shapes (wgmma), padded head dims in every dtype, head dims above
    256 (the wide route); then the wide route, the f32 route and the wgmma
    kernel each timed beside the plain version, PyTorch's fused attention
    in the same dtype and the bound.  Returns the three kernels' entries of
    the JSON line (launches filled later)."""
    from repro_torch.benchmarks import flash_bench
    from repro_torch.kernels import build
    from repro_torch.perf.device import H100_OPS_PER_S
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as FR
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    tol16 = "rtol {rtol}, atol {atol}".format(**FLASH_BF16_TOL)

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    def check(shape, dtype, causal, window, counter, tol=None):
        q, k, v = qkv(shape, dtype)
        before = build.launch_counts()[counter]
        got = FK.flash_attention(q, k, v, causal=causal, window=window)
        if build.launch_counts()[counter] != before + 1:
            raise AssertionError(f"flash {shape} {dtype}: not routed to "
                                 f"{counter}")
        want = FR.sdpa(q, k, v, causal=causal, window=window)
        tol = tol or (FLASH_F32_TOL if dtype == torch.float32
                      else FLASH_BF16_TOL)
        need = atol_needed(got, want, tol["rtol"])
        torch.testing.assert_close(got.float(), want.float(), **tol)
        return float((got.float() - want.float()).abs().max()), need

    cases = [(s, d, causal, None) for s in (128, 256, 512)
             for d in (32, 64, 128) for causal in (True, False)]
    cases += [(256, 64, True, w) for w in (32, 64, 128)]
    f32 = [check((1, 2, s, d), torch.float32, causal, window,
                 "flash_attention") for s, d, causal, window in cases]
    err_f32 = max(e for e, _ in f32)
    log(f"[flash] {len(cases)} small f32 cases (the f32 route, split kernel) "
        f"ok (rtol 1e-5, atol 2e-6), max abs err {err_f32:.3e}, least atol "
        f"that passes at that rtol {max(n for _, n in f32):.3e}")
    fp16 = [(s, d, causal, w) for s in (200, 320) for d in (64, 128)
            for causal, w in ((True, None), (False, None), (True, 64))]
    f16 = [check((2, 3, s, d), torch.float16, causal, window,
                  "flash_attention_wgmma") for s, d, causal, window in fp16]
    err_f16 = max(e for e, _ in f16)
    log(f"[flash] {len(fp16)} ragged fp16 cases (wgmma kernel) ok "
        f"({tol16}), max abs err {err_f16:.3e}, least atol that passes at "
        f"that rtol {max(n for _, n in f16):.3e}")
    pad, pad_need = {}, {}
    for d in (48, 80, 96, 256):
        for dtype, counter in ((torch.float32, "flash_attention"),
                               (torch.bfloat16, "flash_attention_wgmma"),
                               (torch.float16, "flash_attention_wgmma")):
            key = f"{d}/{str(dtype)[6:]}"
            pad[key], pad_need[key] = check((1, 2, 320, d), dtype, True,
                                            None, counter)
    log("[flash] padded head dims ok, max abs err " + ", ".join(
        f"{k} {v:.2e}" for k, v in pad.items()) + "; least atol that "
        "passes at the case's rtol " + ", ".join(
        f"{k} {v:.2e}" for k, v in pad_need.items()))

    wide, wide_need = {}, {}
    for d in FLASH_WIDE_DIMS:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for causal, window in ((True, None), (False, None), (True, 64)):
                mask = "causal" if causal else "full"
                key = f"{d}/{str(dtype)[6:]}/{mask}" \
                    + (f"/w{window}" if window else "")
                wide[key], wide_need[key] = check(
                    (1, 2, 200, d), dtype, causal, window,
                    "flash_attention_wide", FLASH_WIDE_TOL[dtype])
    log("[flash] head dims above 256 (the wide route, split kernel) ok ("
        + "; ".join(f"{str(t)[6:]} rtol {v['rtol']} / atol {v['atol']}"
                    for t, v in FLASH_WIDE_TOL.items()) + "), max abs err "
        + ", ".join(f"{k} {v:.2e}" for k, v in wide.items())
        + "; least atol that passes at the case's rtol " + ", ".join(
            f"{k} {v:.2e}" for k, v in wide_need.items()))

    lib_path = build.build()
    hgmma = _hgmma_by_kernel(lib_path, SPLIT_KERNEL)
    if len(hgmma) < 3 or min(hgmma.values()) == 0:
        raise AssertionError(f"flash: an instance of {SPLIT_KERNEL} without "
                             f"HGMMA in its SASS: {hgmma}")
    log(f"[flash] HGMMA in each split-kernel instance's SASS: {hgmma}")

    def timed(shape, dtype, tol):
        """One causal call at ``shape`` held to the plain version at
        ``tol``, then benchmarks/flash_bench.py's timings on the same
        inputs: ms, plain ms, library ms and the bound."""
        b, h, s, d = shape
        q, k, v = qkv(shape, dtype)
        got = FK.flash_attention(q, k, v, causal=True)
        want = FR.sdpa(q, k, v, causal=True)
        err = (got.float() - want.float()).abs()
        small = want.float().abs() < FLASH_SMALL_O
        r = dict(shape=list(shape), dtype=str(dtype)[6:], causal=True,
                 max_abs_err=float(err.max()),
                 max_abs_err_small_o=float(err[small].max()),
                 small_o_share=float(small.float().mean()),
                 atol_needed=atol_needed(got, want, tol["rtol"]))
        if dtype != torch.float32:
            r["bitwise_share"] = float(
                (got.view(torch.int16) == want.view(torch.int16))
                .float().mean())
        log(f"[flash] {shape} {r['dtype']} causal: max abs err "
            f"{r['max_abs_err']:.3e}, least atol that passes at rtol "
            f"{tol['rtol']} {r['atol_needed']:.3e} (checked at atol "
            f"{tol['atol']})")
        torch.testing.assert_close(got.float(), want.float(), **tol)
        del got, want, err, small
        torch.cuda.empty_cache()
        r.update(flash_bench.time_case(q, k, v))
        del q, k, v
        torch.cuda.empty_cache()
        r["tflops"] = 2 * b * h * s * s * d / (r["ms"] / 1e3) / 1e12
        return r

    wide_t = timed(FLASH_WIDE_TIMED, torch.bfloat16,
                   FLASH_WIDE_TOL[torch.bfloat16])
    log(f"[flash] wide route at {FLASH_WIDE_TIMED} bf16 causal ok: "
        f"{wide_t['ms']:.3f} ms (plain "
        f"{wide_t['plain_ms']:.3f} ms, scaled_dot_product_attention "
        f"{wide_t['library_ms']:.3f} ms, bound {wide_t['bound_ms']:.3f} ms "
        f"by {wide_t['bound_by']}), max abs err {wide_t['max_abs_err']:.3e}, "
        f"{wide_t['bitwise_share']:.4f} of outputs bitwise the plain "
        "version's")
    f32_t = timed(FLASH_SERVE_SHAPE, torch.float32, FLASH_F32_TOL)
    b, h, s, d = FLASH_SERVE_SHAPE
    f32_t["split_floor_ms"] = (F32_SPLIT_PASSES * 2 * b * h * s * s * d
                               / H100_OPS_PER_S["tf32"] * 1e3)
    log(f"[flash] f32 route at {FLASH_SERVE_SHAPE} f32 causal ok "
        f"(rtol {FLASH_F32_TOL['rtol']}, atol "
        f"{FLASH_F32_TOL['atol']}; least atol that passes "
        f"{f32_t['atol_needed']:.3e}): {f32_t['ms']:.3f} ms "
        f"({f32_t['tflops']:.1f} TFLOP/s; plain "
        f"{f32_t['plain_ms']:.3f} ms, f32 scaled_dot_product_attention "
        f"{f32_t['library_ms']:.3f} ms, bound {f32_t['bound_ms']:.3f} ms by "
        f"{f32_t['bound_by']} at the TF32 rate, the split's floor of "
        f"{F32_SPLIT_PASSES} TF32 passes {f32_t['split_floor_ms']:.3f} ms), "
        f"max abs err {f32_t['max_abs_err']:.3e}")
    bf = timed(FLASH_SERVE_SHAPE, torch.bfloat16, FLASH_BF16_TOL)
    log(f"[flash] wgmma kernel at {FLASH_SERVE_SHAPE} bf16 causal ok "
        f"({tol16}; {bf['bitwise_share']:.4f} of outputs bitwise the plain "
        f"version's, floor {FLASH_BITWISE_FLOOR}), max abs err "
        f"{bf['max_abs_err']:.3e}, at |o| < {FLASH_SMALL_O} "
        f"({bf['small_o_share']:.4f} of outputs) "
        f"{bf['max_abs_err_small_o']:.3e}; least atol that passes at rtol "
        f"{FLASH_BF16_TOL['rtol']} {bf['atol_needed']:.3e}; "
        f"{bf['ms']:.3f} ms, "
        f"{bf['tflops']:.1f} TFLOP/s; "
        f"plain {bf['plain_ms']:.3f} ms, scaled_dot_product_attention "
        f"{bf['library_ms']:.3f} ms, bound {bf['bound_ms']:.3f} ms by "
        f"{bf['bound_by']}")
    if bf["bitwise_share"] < FLASH_BITWISE_FLOOR:
        raise AssertionError(f"flash wgmma: only {bf['bitwise_share']} of "
                             "outputs bitwise the plain version's")
    common = dict(route="cuda",
                  replaces="src/repro/kernels/flash_attn/kernel.py:84",
                  ok=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "max_abs_err")
    wgmma = dict(
        name="flash_attention_wgmma",
        source="src/repro_torch/csrc/flash_attn_sm90.cu",
        **{k: bf[k] for k in keys},
        max_abs_err_fp16_ragged=err_f16,
        max_abs_err_small_o=bf["max_abs_err_small_o"],
        atol_needed=bf["atol_needed"], atol_needed_padded=pad_need,
        bitwise_share=bf["bitwise_share"], launches_per_prefill=28,
        timed_on=bf["shape"], timed_dtype=bf["dtype"], **common)
    f32_e = dict(
        name="flash_attention",
        source="src/repro_torch/csrc/flash_attn_sm90_split.cu",
        **{k: f32_t[k] for k in keys},
        split_floor_ms=f32_t["split_floor_ms"],
        atol_needed=f32_t["atol_needed"], max_abs_err_f32_small=err_f32,
        max_abs_err_padded=pad, hgmma_in_sass=hgmma,
        launches_per_f32_prefill=28, timed_on=f32_t["shape"],
        timed_dtype=f32_t["dtype"], **common)
    wide_e = dict(
        name="flash_attention_wide",
        source="src/repro_torch/csrc/flash_attn_sm90_split.cu",
        **{k: wide_t[k] for k in keys},
        max_abs_err_cases=wide, atol_needed=wide_need,
        bitwise_share=wide_t["bitwise_share"], hgmma_in_sass=hgmma,
        timed_on=wide_t["shape"], timed_dtype=wide_t["dtype"], **common)
    return f32_e, wgmma, wide_e


def _teacher_forced(eng, toks: torch.Tensor, s: int, n: int):
    """Prefill logits and ``n`` teacher-forced decode logits of ``eng``'s
    model on ``toks`` (B, s + n), as f32 on the CPU."""
    from repro_torch.models import transformer as T
    cfg = eng.cfg
    toks = toks.to(eng.device)
    with torch.inference_mode():
        logits, caches = T.prefill(eng.params, {"tokens": toks[:, :s]}, cfg,
                                   cache_len=s + n)
        out = [logits.float().cpu()]
        for i in range(n):
            logits, caches = T.decode_step(
                eng.params, {"tokens": toks[:, s + i:s + i + 1]}, caches,
                s + i, cfg)
            out.append(logits.float().cpu())
    return out


def phase_serve_small() -> float:
    """The serving engine's model on the card and on the CPU from one
    seed, with attn_impl="pallas": prefill and 8 teacher-forced decode
    steps give the same logits within SERVE_SMALL_TOL."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    sp = SERVE_SMALL
    cfg = dataclasses.replace(get_config(sp["arch"]), attn_impl="pallas")
    params = T.init_params(cfg, torch.Generator().manual_seed(sp["seed"]))
    toks = torch.randint(0, cfg.vocab, (sp["batch"], sp["prompt"]
                                        + sp["steps"]),
                         generator=torch.Generator().manual_seed(1))
    before = build.launch_counts()
    card = _teacher_forced(ServeEngine(cfg, params, device="cuda"), toks,
                           sp["prompt"], sp["steps"])
    after = build.launch_counts()
    if (after["flash_attention"] != before["flash_attention"] + cfg.n_layers
            or after["flash_attention_wgmma"]
            != before["flash_attention_wgmma"]):
        raise AssertionError("serve-small: the card's f32 prefill did not "
                             "run the f32 flash route once per layer")
    cpu = _teacher_forced(ServeEngine(cfg, params, device="cpu"), toks,
                          sp["prompt"], sp["steps"])
    err = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"serve-small: non-finite logits at {i}")
        torch.testing.assert_close(a, b, **SERVE_SMALL_TOL)
        err = max(err, float((a - b).abs().max()))
    log(f"[serve-small] {sp['arch']} card vs cpu: prefill + {sp['steps']} "
        f"teacher-forced decode logits agree (rtol/atol 1e-4), max abs err "
        f"{err:.3e}")
    return err


def phase_serve_main():
    """The serving path through ServeEngine.generate at full size; launch
    counts read around exactly the measured generate call."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve import GenerationConfig, ServeEngine
    sv = SERVE
    cfg = dataclasses.replace(get_config(sv["arch"]), attn_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(sv["seed"])
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    eng = ServeEngine(cfg, params, device="cuda")
    del params
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (sv["batch"], sv["prompt"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up at the same shapes: cuBLAS handles, the allocator's pools
    eng.generate(prompts, GenerationConfig(max_new_tokens=2))
    gc = GenerationConfig(max_new_tokens=sv["new_tokens"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, gc)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"ef_compress": 0, "decompress": 0, "adam_step": 0,
            "flash_attention": 0, "flash_attention_wgmma": cfg.n_layers,
            "flash_attention_wide": 0, **NO_HEAD}
    if counts != want:
        raise AssertionError(f"serve launch counts {counts}, expected {want}")
    tokens = out["tokens"]
    if tuple(tokens.shape) != (sv["batch"], sv["new_tokens"]) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"serve: bad tokens {tokens.shape}")
    # the logits behind the first two tokens, outside the counted run
    with torch.inference_mode():
        logits, caches = T.prefill(eng.params, {"tokens": prompts}, cfg,
                                   cache_len=sv["prompt"] + 1)
        logits2, _ = T.decode_step(eng.params, {"tokens": tokens[:, :1]},
                                   caches, sv["prompt"], cfg)
        finite = bool(torch.isfinite(logits).all()
                      and torch.isfinite(logits2).all())
        first_same = float((logits[:, :cfg.vocab].float().argmax(-1)
                            == tokens[:, 0]).float().mean())
    del logits, logits2, caches
    if not finite:
        raise AssertionError("serve: non-finite logits")
    dec = out["decode_ms"]
    med = sorted(dec)[len(dec) // 2]
    n_tok = sv["batch"] * sv["new_tokens"]
    stats = dict(
        arch=sv["arch"], batch=sv["batch"], prompt=sv["prompt"],
        new_tokens=sv["new_tokens"], setup_s=setup_s,
        prefill_ms=out["prefill_ms"], decode_ms=dec,
        decode_ms_median=med, generate_wall_ms=wall_ms,
        tokens_per_s=n_tok / (wall_ms / 1e3),
        decode_tokens_per_s=sv["batch"] / (med / 1e3),
        prefill_tokens_per_s=sv["batch"] * sv["prompt"]
        / (out["prefill_ms"] / 1e3),
        peak_bytes=peak, first_token_matches_prefill_argmax=first_same)
    log(f"[serve-main] {sv['arch']} batch {sv['batch']} x prompt "
        f"{sv['prompt']}, {sv['new_tokens']} new tokens: prefill "
        f"{out['prefill_ms']:.1f} ms, decode median {med:.2f} ms/step "
        f"(min {min(dec):.2f}, max {max(dec):.2f}), generate wall "
        f"{wall_ms:.1f} ms, {stats['tokens_per_s']:.1f} tokens/s overall, "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s in decode, peak "
        f"memory {peak} bytes, launches {counts}, set-up {setup_s:.1f} s")
    return counts, stats, eng, prompts


def phase_serve_f32() -> dict:
    """Phase 9b: the f32 prefill at full llama3.2-3b width through
    ServeEngine.generate; launch counts read around exactly the measured
    generate call; last-position logits against attn_impl="full"."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve import GenerationConfig, ServeEngine
    sv = SERVE_F32
    cfg = dataclasses.replace(get_config(sv["arch"]), attn_impl="pallas",
                              compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(sv["seed"])
    t0 = time.perf_counter()
    # the f32 weights are the engine's own (no cast); the full-attention
    # engine below shares them
    eng = ServeEngine(cfg, T.init_params(cfg, gen, device="cuda"),
                      device="cuda")
    prompts = torch.randint(0, cfg.vocab, (sv["batch"], sv["prompt"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up on a short prompt: the f32 cuBLAS paths, the kernel's first
    # launch
    eng.generate(prompts[:, :128], GenerationConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, GenerationConfig(
        max_new_tokens=sv["new_tokens"]))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {"ef_compress": 0, "decompress": 0, "adam_step": 0,
            "flash_attention": cfg.n_layers, "flash_attention_wgmma": 0,
            "flash_attention_wide": 0, **NO_HEAD}
    if counts != want:
        raise AssertionError(f"serve-f32 launch counts {counts}, expected "
                             f"{want}")
    tokens = out["tokens"]
    if tuple(tokens.shape) != (sv["batch"], sv["new_tokens"]) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"serve-f32: bad tokens {tokens.shape}")
    full = ServeEngine(dataclasses.replace(cfg, attn_impl="full"),
                       eng.params, device="cuda")
    with torch.inference_mode():
        got, _ = T.prefill(eng.params, {"tokens": prompts}, cfg)
        ref, _ = T.prefill(full.params, {"tokens": prompts}, full.cfg)
    got, ref = got[:, :cfg.vocab].float(), ref[:, :cfg.vocab].float()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("serve-f32: non-finite logits")
    err = float((got - ref).abs().max())
    need = atol_needed(got, ref, SERVE_F32_TOL["rtol"])
    first_same = float((got.argmax(-1) == tokens[:, 0]).float().mean())
    torch.testing.assert_close(got, ref, **SERVE_F32_TOL)
    stats = dict(
        arch=sv["arch"], compute_dtype="float32", batch=sv["batch"],
        prompt=sv["prompt"], new_tokens=sv["new_tokens"], setup_s=setup_s,
        prefill_ms=out["prefill_ms"], decode_ms=out["decode_ms"],
        generate_wall_ms=wall_ms,
        prefill_tokens_per_s=sv["batch"] * sv["prompt"]
        / (out["prefill_ms"] / 1e3),
        peak_bytes=peak, launches=counts, logits_max_abs_err=err,
        logits_atol_needed=need, logits_abs_max=float(ref.abs().max()),
        first_token_matches_prefill_argmax=first_same)
    log(f"[serve-f32] {sv['arch']} f32, batch {sv['batch']} x prompt "
        f"{sv['prompt']}, {sv['new_tokens']} new tokens: prefill "
        f"{out['prefill_ms']:.1f} ms, decode "
        + ", ".join(f"{x:.2f}" for x in out["decode_ms"])
        + f" ms, generate wall {wall_ms:.1f} ms, peak memory {peak} bytes, "
        f"launches {counts}; last-position logits against attn_impl="
        f"\"full\" within rtol/atol 1e-4: max abs err {err:.3e} (|logits| "
        f"up to {stats['logits_abs_max']:.3f}), least atol that passes "
        f"{need:.3e}; first token = the prefill argmax in {first_same:.3f} "
        f"of rows; set-up {setup_s:.1f} s")
    del eng, full, prompts, got, ref
    torch.cuda.empty_cache()
    return stats


def _flat_grad(ts, batch) -> float:
    """This step's flat f32 gradient of the main path's model into
    ``ts.g``; returns the loss."""
    from repro_torch.models.transformer import loss_fn
    ts.g.zero_()
    loss, _ = loss_fn(ts.model, batch)
    loss.backward()
    return float(loss.detach())


def _event_ms(fn):
    """(fn's result, CUDA-event ms around the one call)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _differs(got, want, terms=None) -> dict:
    """Max abs difference, elements not bitwise equal, and (with
    ``terms``) elements beyond ORACLE_WARM_RTOL of their terms."""
    diff = (got.float() - want.float()).abs()
    out = {"max_abs": float(diff.max()),
           "n_unequal": int((got != want).sum())}
    if terms is not None:
        out["n_beyond_tol"] = int((diff > ORACLE_WARM_RTOL * terms).sum())
    return out


def phase_oracles() -> dict:
    """Phase 11: the functional oracles (``core.onebit_adam``) against the
    registry ``onebit_adam`` at full BERT-Large, each step from the same
    state and the same gradient of the main path's model; launch counts
    set to 0 around the oracle's own updates."""
    from repro_torch.core import onebit_adam as OB
    from repro_torch.core.compression import CompressionConfig
    from repro_torch.kernels import build
    from repro_torch.launch.train import lr_schedule
    from repro_torch.train.step import optimizer_from_config, seed_zero1
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ocfg = OB.OneBitAdamConfig(compression=CompressionConfig(
        block_size=FAMILY["block_size"]))
    opt = optimizer_from_config(ocfg)
    ts, stream = _family_state(opt)
    st = OB.init(ts.x.shape[0], 1, ts.x.device)
    # the registry's state holds the oracle's tensors (its own zeros go)
    ts.opt = ts.opt._replace(m=st.m, v=st.v, worker_err=st.worker_err,
                             server_err=st.server_err, count=st.count)
    launches = {k: 0 for k in build.launch_counts()}
    steps, (w, c) = [], ORACLE_STEPS
    t_phase = time.perf_counter()
    for step in range(w + c + 1):
        warm = step < w
        loss = _flat_grad(ts, stream.batch_at(step))
        lr = float(np.float32(lr_schedule(step, 1e-3, 20)))
        if step == w + c:
            break               # the zero1 step below takes this gradient
        build.reset_launch_counts()
        fn = OB.warmup_update if warm else OB.compressed_update
        (ox, ost, ostats), o_ms = _event_ms(
            lambda: fn(ts.g, st, ts.x, ocfg, lr))
        for k, v in build.launch_counts().items():
            launches[k] += v
        reg = ts.opt._replace(m=st.m, v=st.v, worker_err=st.worker_err,
                              server_err=st.server_err, count=st.count)
        if warm:
            (rx, rst, rstats), r_ms = _event_ms(
                lambda: opt.warmup_update(ts.g, reg, ts.x, lr))
        else:
            (rx, rst, rstats), r_ms = _event_ms(
                lambda: opt.update(ts.g, reg, lr, x=ts.x))
        rec = {"step": step, "stage": "warmup" if warm else "compressed",
               "loss": loss, "oracle_ms": o_ms, "registry_ms": r_ms}
        if int(ost.count) != int(rst.count):
            raise AssertionError(f"oracles step {step}: counts differ")
        if warm:
            # the registry takes the fused kernel, (1-b2)*g*g; the oracle
            # the reference's (1-b2)*square(g): v and, through it, x
            # differ at the ULP, each held at rtol 1e-6 of the terms it is
            # formed from (x - lr*upd cancels where x is near lr*upd)
            upd_terms = ost.m.abs() / (ost.v.sqrt() + ocfg.eps)
            terms = {"x": ts.x.abs() + lr * upd_terms,
                     "m": 0.9 * st.m.abs() + 0.1 * ts.g.abs(),
                     "v": ost.v.abs()}
            del upd_terms
        else:
            terms = {}
        for name, got, want in (("x", ox, rx), ("m", ost.m, rst.m),
                                ("v", ost.v, rst.v),
                                ("worker_err", ost.worker_err,
                                 rst.worker_err),
                                ("server_err", ost.server_err,
                                 rst.server_err)):
            rec[name] = _differs(got, want, terms.get(name))
            bad = rec[name].get("n_beyond_tol", rec[name]["n_unequal"])
            if bad:
                raise AssertionError(f"oracles step {step} ({rec['stage']})"
                                     f": {name} {rec[name]}")
        rec["stats"] = {k: [float(ostats[k]), float(rstats[k])]
                        for k in ostats}
        del rx, rst, rstats, reg, terms
        st = ost
        with torch.no_grad():
            ts.x[:ts.d].copy_(ox[:ts.d])
        del ox, ost
        log(f"[oracles] step {step} [{rec['stage']}] loss {loss:.4f}: "
            f"oracle {o_ms:.2f} ms, registry {r_ms:.2f} ms; max abs diff "
            + ", ".join(f"{k} {rec[k]['max_abs']:.3e} ({rec[k]['n_unequal']}"
                        " unequal)" for k in ("x", "m", "v", "worker_err",
                                              "server_err")))
        steps.append(rec)
    want = dict(ORACLE_LAUNCHES, **NO_FLASH, **NO_HEAD)
    if launches != want:
        raise AssertionError(f"oracles: launch counts {launches}, expected "
                             f"{want}")

    # one ZeRO-1 compressed step at n_dp = 1 from the oracle's state
    ts.opt = ts.opt._replace(m=st.m, v=st.v, worker_err=st.worker_err,
                             server_err=st.server_err, count=st.count)
    seed_zero1(ts, opt)
    z = OB.ZeroOneBitAdamState(
        m=st.m, v_shard=ts.opt.v_shard, master_shard=ts.opt.master_shard,
        worker_err=st.worker_err, server_err=st.server_err, count=st.count)
    del st
    build.reset_launch_counts()
    (ox, oz, _), o_ms = _event_ms(
        lambda: OB.zero1_compressed_update(ts.g, z, ocfg, lr))
    z1_launches = build.launch_counts()
    (rx, rz, _), r_ms = _event_ms(lambda: opt.update(ts.g, ts.opt, lr))
    z1 = {"oracle_ms": o_ms, "registry_ms": r_ms, "launches": z1_launches}
    for name, got, want in (("x_bf16", ox, rx),
                            ("master_shard", oz.master_shard,
                             rz.master_shard), ("m", oz.m, rz.m),
                            ("worker_err", oz.worker_err, rz.worker_err),
                            ("server_err", oz.server_err, rz.server_err)):
        z1[name] = _differs(got, want)
        if z1[name]["n_unequal"]:
            raise AssertionError(f"oracles zero1: {name} {z1[name]}")
    if z1_launches != dict(ORACLE_ZERO1_LAUNCHES, **NO_FLASH, **NO_HEAD):
        raise AssertionError(f"oracles zero1: launch counts {z1_launches}")
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t_phase
    log(f"[oracles] zero1 step: bitwise the registry's zero1 update "
        f"(oracle {o_ms:.2f} ms, registry {r_ms:.2f} ms); oracle launches "
        f"over {w} + {c} steps {launches}; peak memory {peak} bytes; "
        f"{wall:.1f} s")
    del ts, ox, oz, rx, rz, z
    torch.cuda.empty_cache()
    return dict(steps=steps, zero1=z1, launches=launches, peak_bytes=peak,
                wall_s=wall)


def phase_claims() -> dict:
    """Phase 12: the paper's claim benchmarks on the card at the
    reference's sizes, then the variance system phase at full BERT-Large;
    each one's launch counts set to 0 before and read after it."""
    from repro_torch.benchmarks import block_size_ablation as BS
    from repro_torch.benchmarks import convergence as CV
    from repro_torch.benchmarks import variance_stability as VS
    from repro_torch.kernels import build
    out = {}

    def part(name, fn, kernels, verdict):
        torch.cuda.empty_cache()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        secs = time.perf_counter() - t0
        counts = build.launch_counts()
        missing = [k for k in kernels if not counts[k]]
        if missing:
            raise AssertionError(f"claims {name}: no launch of {missing} "
                                 f"({counts})")
        ok = verdict(res)
        out[name] = dict(result=res, verdict="PASS" if ok else "FAIL",
                         seconds=secs, launches=counts)
        log(f"[claims] {name}: {'PASS' if ok else 'FAIL'} in {secs:.1f} s, "
            f"launches {counts}")
        return res

    rows = part("block_size_ablation", lambda: BS.run(device="cuda"),
                ("ef_compress", "decompress"), BS.passes)
    if not all(math.isfinite(r["toy_final_loss"]) for r in rows.values()):
        raise AssertionError(f"claims: non-finite toy loss {rows}")
    res = part("variance_stability",
               lambda: VS.run(segments=CLAIMS_SEGMENTS, device="cuda"),
               ("adam_step",),
               lambda r: r["mechanism_ok"] and r["system_wiring_ok"])
    if not res["system_losses_finite"]:
        raise AssertionError("claims: non-finite loss in the variance "
                             "system phase")
    curves = {}
    res = part("convergence", lambda: CV.run(device="cuda", curves=curves),
               ("adam_step", "ef_compress", "decompress"),
               lambda r: r["ok"])
    if not res["finite"]:
        raise AssertionError("claims: non-finite loss in convergence")
    out["convergence"]["first_losses"] = {k: v[:3] for k, v in
                                          curves.items()}
    res = part("variance_system_bert_large",
               lambda: VS.system_phase(device="cuda", **CLAIMS_SYSTEM),
               ("adam_step",),
               lambda r: r["freeze_step"] is not None
               and r["freeze_step"] >= r["lr_warmup"])
    if not res["losses_finite"]:
        raise AssertionError("claims: non-finite loss in the full-width "
                             "variance system phase")
    log(f"[claims] full-width variance system phase: the Sec. 7.1 rule "
        f"fired at step {res['freeze_step']} (ratio "
        f"{res['ratio_at_freeze']}), ratio at the end {res['ratio_last']}")
    return out


def phase_serve_profile(eng, prompts) -> dict:
    """One prefill and one decode step of the serving model under
    torch.profiler: device time by kernel group and the idle share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    cfg, s = eng.cfg, prompts.shape[1]
    out = {}
    with torch.inference_mode():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, caches = T.prefill(eng.params, {"tokens": prompts}, cfg,
                                       cache_len=s + 2)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["prefill"] = _device_breakdown(prof, wall_ms)
        tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True)
        T.decode_step(eng.params, {"tokens": tok}, caches, s, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            T.decode_step(eng.params, {"tokens": tok}, caches, s + 1, cfg)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out["decode"] = _device_breakdown(prof, wall_ms)
    for what, r in out.items():
        _log_breakdown("serve-profile", what, r)
    return out


def phase_plan(main_losses, main_state, main_stats) -> dict:
    """Phase 13: calibrate the device spec on the card, run the main path
    with every schedule axis ``auto`` on it (bitwise phase 5's), and set
    the model's step time beside the measured one."""
    from repro_torch.benchmarks import kernel_sweep
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    from repro_torch.optim import get_compressor
    from repro_torch.perf.device import DeviceSpec, get_device
    from repro_torch.plan import flat_schedule, get_cluster, predict_step_time
    # 1. calibrate
    workdir = tempfile.mkdtemp(prefix="chip_smoke_plan_")
    path = os.path.join(workdir, "device.json")
    build.reset_launch_counts()
    t0 = time.perf_counter()
    fit = kernel_sweep.run(json_path=path)
    sweep_s = time.perf_counter() - t0
    sweep_launches = build.launch_counts()
    spec = DeviceSpec.from_measured(path, base="h100-sxm")
    shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.empty_cache()
    if fit["peak_flops"] is None:
        raise AssertionError("plan: the sweep did not observe peak_flops")
    sheet = get_device("h100-sxm")
    shares = {"hbm_bw": spec.hbm_bw / sheet.hbm_bw,
              "peak_flops": spec.peak_flops / sheet.peak_flops}
    log(f"[plan] calibrated in {sweep_s:.1f} s ({len(fit['samples'])} "
        f"samples; launches {sweep_launches}): hbm_bw {spec.hbm_bw:.6e} B/s "
        f"({shares['hbm_bw']:.1%} of the data sheet's {sheet.hbm_bw:.3e}), "
        f"peak_flops {spec.peak_flops:.6e} FLOP/s "
        f"({shares['peak_flops']:.1%} of {sheet.peak_flops:.3e}), "
        f"kernel_overhead {spec.kernel_overhead * 1e6:.3f} us")
    over = {k: v for k, v in shares.items() if v > PLAN_SHARE_MAX}
    if over:
        raise AssertionError(f"plan: fitted rates above the data sheet: "
                             f"{over}")
    # 2. tune and run
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = run(device="cuda", **MAIN, **PLAN_RUN, device_spec=spec)
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    pick = res["schedule"]
    if pick is None or res["n_buckets"] != pick.n_buckets:
        raise AssertionError(f"plan: the run did not take the tuner's pick "
                             f"({res['n_buckets']} buckets, pick {pick})")
    nb = res["n_buckets"]
    steps_c = MAIN["steps"] - MAIN["warmup_steps"]
    want = dict(NO_FLASH, adam_step=MAIN["warmup_steps"],
                ef_compress=2 * steps_c * nb, decompress=2 * steps_c * nb,
                **head_launches(MAIN["steps"]))
    if counts != want or res["launches"] != counts:
        raise AssertionError(f"plan: launch counts {counts}, expected "
                             f"{want}")
    hist = res["history"]
    losses = [h["loss"] for h in hist]
    ts = res["state"]
    same = {"losses": losses == main_losses,
            "x": torch.equal(ts.x.cpu(), main_state["x"])}
    for k in PIPE_STATE:
        same[k] = torch.equal(ts.opt[k].cpu(), main_state[k])
    early = [h["stage0_in_bwd"] for h in hist]
    ready = list(pick.ready_times)
    predicted_early = sum(r < max(ready) for r in ready) if ready else 0
    comp_ms = [h["ms"] for h in hist[MAIN["warmup_steps"]:]]
    log(f"[plan] picked {pick.topology} x {nb} bucket(s), overlap "
        f"{'on' if res['overlap_bwd'] else 'off'}, kernels "
        f"{'cuda' if pick.use_kernel else 'plain'}: losses "
        + ", ".join(f"{x:.4f}" for x in losses)
        + f"; bitwise phase 5's: {same}; compressed step ms {comp_ms}; "
        f"stage 0s inside backward {early} (priced {predicted_early} a "
        f"step); peak memory {peak} bytes")
    if not all(same.values()):
        raise AssertionError(f"plan: the auto run is not bitwise phase "
                             f"5's {same}")
    d_pad = res["d_pad"]
    del ts, res
    torch.cuda.empty_cache()
    # 3. the model's step time against the measured one
    cfg = get_config(MAIN["arch"])
    comp = get_compressor("onebit", block_size=MAIN["block_size"])
    plan = flat_schedule(comp, d_pad, 1, ())
    pred = predict_step_time(
        plan, get_cluster(PLAN_RUN["cluster"], 1, 1, device=spec), cfg,
        InputShape("main", MAIN["seq"], MAIN["batch"], "train"),
        comp=comp, use_kernel=True)
    pred_ms = pred["t_step"] * 1e3
    walls = main_stats["compressed_step_ms"]
    busy = main_stats["profile"]["compressed"]["device_busy_ms"]
    log(f"[plan] predicted compressed step {pred_ms:.3f} ms (6ND compute "
        f"{pred['t_compute'] * 1e3:.3f} + exchange compute "
        f"{pred['t_exchange_compute'] * 1e3:.3f} + links "
        f"{pred['t_comm'] * 1e3:.3f}); measured: phase 5 walls {walls} "
        f"ms (ratio " + ", ".join(f"{w / pred_ms:.1f}" for w in walls)
        + f"), phase 6 device busy {busy:.3f} ms (ratio "
        f"{busy / pred_ms:.1f})")
    return {"fit": {k: fit[k] for k in ("hbm_bw", "kernel_overhead",
                                        "peak_flops", "clamped")},
            "shares": shares, "sweep_s": sweep_s,
            "sweep_launches": sweep_launches, "sweep_samples": fit["samples"],
            "pick": pick.summary(), "launches": counts, "losses": losses,
            "bitwise_main": same, "compressed_step_ms": comp_ms,
            "stage0_in_bwd": early, "stage0_in_bwd_priced": predicted_early,
            "peak_bytes": peak, "predicted": pred,
            "measured_compressed_ms": walls, "measured_busy_ms": busy,
            "ratio_wall": [w / pred_ms for w in walls],
            "ratio_busy": busy / pred_ms}


def _obs_log(path):
    from repro_torch.obs.events import validate_records
    with open(path) as f:
        recs = [json.loads(ln) for ln in f if ln.strip()]
    validate_records(recs)
    return recs


def _check_attribution(tag: str, mem: dict) -> dict:
    """A measured (``compiled``) memory event: attributed + residual is
    its output + temporary bytes, exactly."""
    total = mem["output_bytes"] + mem["temp_bytes"]
    if mem["attributed_bytes"] + mem["residual_bytes"] != total:
        raise AssertionError(f"obs {tag}: {mem['program']} attributed "
                             f"{mem['attributed_bytes']} + residual "
                             f"{mem['residual_bytes']} != {total}")
    return {k: mem[k] for k in ("program", "argument_bytes", "output_bytes",
                                "temp_bytes", "peak_bytes",
                                "attributed_bytes", "residual_bytes",
                                "residual_frac", "attribution")}


def phase_obs(main_losses, main_state, main_stats, family) -> dict:
    """Phase 14: the main path observed in process (14a), the CLI with a
    profile in a fresh process (14b), the open memory reading."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    from repro_torch.obs.bench import load_ledger
    from repro_torch.obs.mem import predict_ledger
    from repro_torch.optim import get_compressor, get_optimizer
    from repro_torch.pipeline import Bucketer, lower_to_pipelined
    from repro_torch.pipeline.executor import scoped_op_names
    from repro_torch.obs.profile import cell_key, parse_scope
    from repro_torch.plan import flat_schedule
    from repro_torch.train.step import flat_dim
    workdir = tempfile.mkdtemp(prefix="chip_smoke_obs_")
    out = {}
    try:
        # --- 14a: in process ------------------------------------------
        tel = os.path.join(workdir, "tel")
        torch.cuda.empty_cache()
        build.reset_launch_counts()
        res = run(device="cuda", **MAIN, **OBS_RUN, telemetry=tel)
        counts = build.launch_counts()
        hist = res["history"]
        losses = [h["loss"] for h in hist]
        ts = res["state"]
        same = {"losses": losses == main_losses,
                "x": torch.equal(ts.x.cpu(), main_state["x"])}
        for k in PIPE_STATE:
            same[k] = torch.equal(ts.opt[k].cpu(), main_state[k])
        del ts, res
        torch.cuda.empty_cache()
        log(f"[obs] 14a: losses " + ", ".join(f"{x:.4f}" for x in losses)
            + f"; bitwise phase 5's: {same}; launches {counts}")
        if not all(same.values()):
            raise AssertionError(f"obs: the observed run is not bitwise "
                                 f"phase 5's {same}")
        if counts != OBS_LAUNCHES:
            raise AssertionError(f"obs: launch counts {counts}, expected "
                                 f"{OBS_LAUNCHES}")
        recs = _obs_log(os.path.join(tel, "telemetry.jsonl"))
        by = {}
        for r in recs:
            by.setdefault(r["type"], []).append(r)
        mems = by.get("memory", [])
        kinds = [m["kind"] for m in mems]
        audit_health = [r for r in by.get("health", [])
                        if r.get("source") == "repro_torch.obs.audit"]
        compiled = {m["program"]: m for m in mems if m["kind"] == "compiled"}
        found = {"step": len(by.get("step", [])),
                 "fidelity": len(by.get("fidelity", [])),
                 "audit_health": len(audit_health),
                 "predicted": kinds.count("predicted"),
                 "compiled": sorted(compiled), "live": kinds.count("live")}
        want = {"step": 6, "fidelity": 3, "audit_health": 3,
                "predicted": 1, "compiled": ["compressed", "warmup"],
                "live": 6}
        log(f"[obs] 14a log: {len(recs)} records validated; {found}")
        if found != want:
            raise AssertionError(f"obs: the log holds {found}, expected "
                                 f"{want}")
        att = {p: _check_attribution("14a", m) for p, m in compiled.items()}
        [pred] = [m for m in mems if m["kind"] == "predicted"]
        peak5 = main_stats["peak_bytes"]
        for p, a in sorted(att.items()):
            log(f"[obs] 14a {p}: measured peak {a['peak_bytes']:.0f} B "
                f"(arguments {a['argument_bytes']:.0f}, outputs "
                f"{a['output_bytes']:.0f}, temporaries "
                f"{a['temp_bytes']:.0f}); attributed "
                f"{a['attributed_bytes']:.0f} + residual "
                f"{a['residual_bytes']:.0f} (residual_frac "
                f"{a['residual_frac']:.4f}) {a['attribution']}")
        log(f"[obs] 14a predicted total {pred['total_bytes']:.0f} B "
            f"{pred['categories']}; phase 5's peak {peak5} B")
        comp_ms = [h["ms"] for h in hist[MAIN["warmup_steps"]:]]
        log(f"[obs] 14a compressed step ms {comp_ms} (audit probe before "
            f"each, outside the wall) vs phase 5's "
            f"{main_stats['compressed_step_ms']}")
        fid = by["fidelity"][-1]
        out["a"] = {"launches": counts, "bitwise_main": same,
                    "records": found, "predicted": pred["categories"],
                    "predicted_total": pred["total_bytes"],
                    "measured": att, "main_peak_bytes": peak5,
                    "compressed_step_ms": comp_ms,
                    "main_compressed_step_ms":
                    main_stats["compressed_step_ms"],
                    "warmup_step_ms": [h["ms"] for h in
                                       hist[:MAIN["warmup_steps"]]],
                    "fidelity_last": {k: fid.get(k) for k in
                                      ("v_ratio", "v_drift_max",
                                       "cos_sim_min", "sign_agree_min",
                                       "grad_norm")},
                    "health_ok": [r["ok"] for r in audit_health]}

        # --- 14b: the CLI, in a fresh process ---------------------------
        d = os.path.join(workdir, "cli")
        prof = os.path.join(d, "prof")
        cmd = [sys.executable, "-m", "repro_torch.launch.train"] + \
            OBS_CLI + ["--telemetry", d, "--profile", prof]
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                              timeout=OBS_CLI_TIMEOUT_S)
        cli_s = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[obs] 14b | {line}")
        if proc.returncode != 0:
            raise AssertionError(f"obs: the CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        recs = _obs_log(os.path.join(d, "telemetry.jsonl"))
        profs = [r for r in recs if r["type"] == "profile"]
        if len(profs) != 1:
            raise AssertionError(f"obs: {len(profs)} profile events in the "
                                 "CLI's log, expected 1 (a failed fold is "
                                 "a warning there: "
                                 + str([r for r in recs
                                        if r["type"] == "warning"]) + ")")
        p = profs[0]
        gap = abs(p["t_attributed"] + p["t_residual"] - p["t_window"])
        if not p["t_attributed"] > 0 or gap > OBS_WINDOW_ATOL_S:
            raise AssertionError(f"obs: profile t_attributed "
                                 f"{p['t_attributed']} + t_residual "
                                 f"{p['t_residual']} vs t_window "
                                 f"{p['t_window']}")
        d_pad = flat_dim(get_config(MAIN["arch"]), 1, MAIN["block_size"])
        comp = get_compressor("onebit", block_size=MAIN["block_size"])
        pplan = lower_to_pipelined(
            flat_schedule(comp, d_pad, 1, ()), comp,
            Bucketer.for_exchange(d_pad, 1, MAIN["block_size"],
                                  PIPE_BUCKETS))
        want_cells = {cell_key(parse_scope(n))
                      for n in scoped_op_names(pplan)}
        got_cells = {(c["plan"], c["bucket"], c["stage"], c["kind"],
                      c["tier"]) for c in p["cells"]}
        if not want_cells <= got_cells or not p.get("ready_order"):
            raise AssertionError(f"obs: profile cells {sorted(got_cells)} "
                                 f"miss {sorted(want_cells - got_cells)} "
                                 f"(ready_order {p.get('ready_order')})")
        mems = [r for r in recs if r["type"] == "memory"]
        att_b = {m["program"]: _check_attribution("14b", m)
                 for m in mems if m["kind"] == "compiled"}
        if sorted(att_b) != ["compressed", "warmup"]:
            raise AssertionError(f"obs: 14b measured memory of {att_b}")
        ledger = load_ledger(os.path.join(prof, "BENCH_obs_smoke.json"))
        frac = p["t_attributed"] / p["t_window"]
        log(f"[obs] 14b: exit 0 in {cli_s:.1f} s; s_per_step "
            f"{p['s_per_step']:.6f}, attributed_fraction {frac:.6f}, "
            f"comm_fraction {p['comm_fraction']:.6f}, {p['n_cells']} "
            f"cells ({len(want_cells)} of the pipelined exchange), "
            f"{p['n_unattributed']} device events unattributed; ledger "
            f"{len(ledger['records'])} record(s)")
        out["b"] = {"cli_s": cli_s, "profile": {
            k: p[k] for k in ("n_steps", "t_window", "t_attributed",
                              "t_residual", "s_per_step", "comm_fraction",
                              "overlap_efficiency", "n_cells",
                              "n_unattributed", "ready_order", "cells",
                              "streams")},
            "attributed_fraction": frac, "measured": att_b,
            "ledger_metrics": ledger["records"][0]["metrics"]}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    # --- the open memory reading: phase 6b's zero1 run, accumulation 2 ---
    cfg = get_config(FAMILY["arch"])
    opt = get_optimizer("onebit_adam", compressor="onebit",
                        compressor_kwargs={"block_size":
                                           FAMILY["block_size"]})
    plan = flat_schedule(opt.compressor,
                         flat_dim(cfg, 1, FAMILY["block_size"]), 1, ())
    zl = {}
    for layout in ("replicated", "zero1"):   # its warmup, its compressed
        led = predict_ledger(cfg, (1,), optim=opt, layout=layout,
                             block=FAMILY["block_size"],
                             batch_global=FAMILY["batch"] // 2,
                             seq=FAMILY["seq"], plan=plan)
        zl[layout] = {"categories": dict(led.categories),
                      "total_bytes": led.total_bytes}
        log(f"[obs] zero1_accum predicted ({layout} steps, microbatch "
            f"{FAMILY['batch'] // 2}): total {led.total_bytes:.0f} B "
            f"{dict(led.categories)}")
    peak6b = family["zero1_accum"]["peak_bytes"]
    log(f"[obs] zero1_accum: phase 6b measured peak {peak6b} B")
    out["zero1_accum"] = {"predicted": zl, "measured_peak_bytes": peak6b}
    return out


def _register_phase15_configs() -> None:
    """The cut configs of phase 15, registered with the port's own
    ``register`` (the launcher has no depth flag)."""
    import dataclasses
    from repro_torch.configs import get_config, register
    register(dataclasses.replace(get_config("mixtral-8x22b-smoke"),
                                 name="mixtral-8x22b-smoke-gather",
                                 moe_dispatch="gather"))
    register(dataclasses.replace(get_config("falcon-mamba-7b"),
                                 name=MAMBA_ARCH, n_layers=2))


def _first_payload_flips(arch: str, kw: dict) -> float:
    """The share of the first compressed step's payload sign bits that
    differ between the card and the CPU from one state: the CPU's run of
    the warmup steps, then the compressed step's gradient on each device
    from those parameters and the local momentum b1 m + (1 - b1) g (worker
    error 0), whose signs are the payload."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.launch.train import run
    from repro_torch.models.transformer import Transformer, loss_fn
    cfg, w = get_config(arch), kw["warmup_steps"]
    res = run(device="cpu", **dict(kw, steps=w))
    ts, b1 = res["state"], res["optimizer"].b1
    signs = []
    for dev in ("cuda", "cpu"):
        x = ts.x.to(dev, copy=True)
        g = torch.zeros_like(x)
        model = Transformer(cfg, x)
        model.bind_grads(g)
        batch = SyntheticStream(cfg, InputShape(
            "custom", kw["seq"], kw["batch"], "train"), seed=0,
            device=dev).batch_at(w)
        loss_fn(model, batch)[0].backward()
        with torch.no_grad():
            signs.append((b1 * ts.opt.m.to(dev) + (1.0 - b1) * g
                          >= 0).cpu())
    return float((signs[0] != signs[1]).float().mean())


def phase_families_small() -> dict:
    """15a: each new arch's reduced() config (and the MoE one under the
    gather dispatch) through ``run`` on the card and on the CPU from one
    seed: 3 warmup + 2 compressed steps, batch 4, block 512.  Launch
    counts set to 0 just before the card's run and read just after; aux
    > 0 on the MoE archs and 0 on the others.  The losses of steps 0-3
    (every loss taken before a compressed update) agree within
    SMALL_LOSS_RTOL, and the first compressed payload's sign bits within
    FAMILIES_SIGN_FLIP_CEILING; step 4's loss, after the first compressed
    update, is reported (see FAMILIES_SIGN_FLIP_CEILING)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch)
        kw = dict(FAMILIES_SMALL, arch=arch,
                  seq=FAMILIES_SEQ.get(arch, FAMILIES_SMALL["seq"]),
                  verbose=False)
        w = kw["warmup_steps"]
        t0 = time.perf_counter()
        build.reset_launch_counts()
        card = run(device="cuda", **kw)
        counts = build.launch_counts()
        card_s = time.perf_counter() - t0
        if counts != FAMILIES_SMALL_LAUNCHES or card["launches"] != counts:
            raise AssertionError(f"{arch}: launch counts {counts}, expected "
                                 f"{FAMILIES_SMALL_LAUNCHES}")
        cpu = run(device="cpu", **kw)
        losses = [(a["loss"], b["loss"]) for a, b in
                  zip(card["history"], cpu["history"])]
        aux = [h["aux"] for h in card["history"]]
        if not all(math.isfinite(a) and math.isfinite(b)
                   for a, b in losses):
            raise AssertionError(f"{arch}: non-finite losses {losses}")
        if [a["stage"] for a in card["history"]] != \
                [b["stage"] for b in cpu["history"]]:
            raise AssertionError(f"{arch}: stages differ")
        if cfg.n_experts and not min(aux) > 0:
            raise AssertionError(f"{arch}: MoE aux {aux}, expected > 0")
        if not cfg.n_experts and any(aux):
            raise AssertionError(f"{arch}: aux {aux} without experts")
        rel = [abs(a - b) / abs(b) for a, b in losses]
        if max(rel[:w + 1]) > SMALL_LOSS_RTOL:
            raise AssertionError(f"{arch}: losses {losses[:w + 1]} card/cpu "
                                 f"(rel {rel[:w + 1]})")
        flips = _first_payload_flips(arch, kw)
        if flips > FAMILIES_SIGN_FLIP_CEILING:
            raise AssertionError(f"{arch}: {flips:.2e} of the first "
                                 "compressed payload's sign bits differ "
                                 "card/cpu")
        out[arch] = dict(losses=losses, rel=rel, aux=aux, launches=counts,
                         card_s=card_s, payload_flips=flips)
        log(f"[families-small] {arch}: card vs cpu losses "
            + ", ".join(f"{a:.6f}/{b:.6f}" for a, b in losses)
            + f" (rel through step {w}: max {max(rel[:w + 1]):.2e}; after "
            f"the first compressed update {rel[w + 1:]}); first payload "
            f"{flips:.2e} of its sign bits apart; aux "
            + ", ".join(f"{x:.5f}" for x in aux) + f"; card run "
            f"{card_s:.1f} s")
    return out


def phase_families_main() -> dict:
    """15b: falcon-mamba-7b at full width (2 layers) through ``run``: 3
    warmup + 3 compressed 1-bit Adam steps, batch 2 x seq 2048, block
    4096, seed 0; launch counts read around exactly this run; then one
    compressed step profiled."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    from repro_torch.train.step import train_step
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    res = run(device="cuda", **MAMBA)
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = res["history"]
    w = MAMBA["warmup_steps"]
    losses = [h["loss"] for h in hist]
    stages = [h["stage"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"falcon-mamba-7b: non-finite losses {losses}")
    if stages != ["warmup"] * w + ["compressed"] * (MAMBA["steps"] - w):
        raise AssertionError(f"falcon-mamba-7b: stage did not flip at step "
                             f"{w}: {stages}")
    v_l1 = [h["v_l1"] for h in hist[w - 1:]]
    if len(set(v_l1)) != 1:
        raise AssertionError(f"falcon-mamba-7b: v changed in the "
                             f"compressed stage: {v_l1}")
    if counts != MAMBA_LAUNCHES or res["launches"] != counts:
        raise AssertionError(f"falcon-mamba-7b: launch counts {counts}, "
                             f"expected {MAMBA_LAUNCHES}")
    if any(h["aux"] for h in hist):
        raise AssertionError("falcon-mamba-7b: aux without experts")
    warm_ms = [h["ms"] for h in hist[:w]]
    comp_ms = [h["ms"] for h in hist[w:]]
    log(f"[families-main] falcon-mamba-7b x 2 layers: d={res['d']} "
        f"d_pad={res['d_pad']} losses " + ", ".join(f"{x:.4f}"
                                                   for x in losses))
    log(f"[families-main] warmup step ms {warm_ms}, compressed step ms "
        f"{comp_ms}, peak memory {peak} bytes")
    cfg = get_config(MAMBA_ARCH)
    ts, opt, d, d_pad = res["state"], res["optimizer"], res["d"], \
        res["d_pad"]
    batch = SyntheticStream(cfg, InputShape("profile", MAMBA["seq"],
                                            MAMBA["batch"], "train"),
                            seed=1, device="cuda").batch_at(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(ts, opt, batch, 1e-4, "compressed")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof_out = _device_breakdown(prof, wall_ms)
    _log_breakdown("families-main", "compressed step (profiled)", prof_out)
    del res, ts, opt, prof
    torch.cuda.empty_cache()
    return dict(d=d, d_pad=d_pad, launches=counts, losses=losses,
                warmup_step_ms=warm_ms, compressed_step_ms=comp_ms,
                peak_bytes=peak, profile=prof_out)


def phase_moe_layer() -> dict:
    """15c: mixtral-8x22b's MoE layer alone at full width (d 6144, ff
    16384, 8 experts, top-2), f32 parameters from seed 0, no optimizer;
    bf16 inputs, batch 2 x seq 4096: forward + backward under both
    dispatches; outputs and input gradients held to each other; CUDA-event
    ms of each dispatch and its peak memory."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.mlp import moe_capacity, moe_forward
    dev = torch.device("cuda")
    base = get_config("mixtral-8x22b")
    d, ff, e = base.d_model, base.d_ff, base.n_experts
    gen = torch.Generator(device=dev).manual_seed(MOE_LAYER["seed"])
    p = {"router": torch.randn(d, e, generator=gen, device=dev) * 0.02,
         "wg": torch.randn(e, d, ff, generator=gen, device=dev) * d ** -0.5,
         "wu": torch.randn(e, d, ff, generator=gen, device=dev) * d ** -0.5,
         "wd": torch.randn(e, ff, d, generator=gen, device=dev)
         * ff ** -0.5}
    for t in p.values():
        t.requires_grad_(True)
    b, s = MOE_LAYER["batch"], MOE_LAYER["seq"]
    x0 = torch.randn(b, s, d, generator=gen, device=dev).to(torch.bfloat16)
    cot = torch.randn(b, s, d, generator=gen, device=dev).to(torch.bfloat16)
    cap = moe_capacity(base, b * s)
    out = {"capacity": cap, "tokens": b * s}
    res = {}
    for dispatch in ("einsum", "gather"):
        cfg = dataclasses.replace(base, moe_dispatch=dispatch)

        def fwd_bwd():
            for t in p.values():
                t.grad = None
            x = x0.clone().requires_grad_(True)
            y, aux = moe_forward(p, x, cfg)
            ((y.float() * cot.float()).sum() + aux).backward()
            return y.detach(), aux.detach(), x.grad

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        res[dispatch] = fwd_bwd()
        peak = torch.cuda.max_memory_allocated()
        times = sorted(_event_ms(fwd_bwd)[1] for _ in range(MOE_LAYER_REPS))
        out[dispatch] = dict(ms=times[len(times) // 2], ms_all=times,
                             peak_bytes=peak)
        log(f"[moe-layer] {dispatch}: forward + backward "
            f"{out[dispatch]['ms']:.2f} ms (median of {MOE_LAYER_REPS}: "
            f"{', '.join(f'{t:.2f}' for t in times)}), peak {peak} bytes")
    (ye, ae, ge), (yg, ag, gg) = res["einsum"], res["gather"]
    for name, a, w_ in (("output", yg, ye), ("input gradient", gg, ge)):
        diff = (a.float() - w_.float()).abs()
        out[name] = dict(max_abs=float(diff.max()),
                         bitwise_share=float((a == w_).float().mean()),
                         atol_needed=atol_needed(a, w_,
                                                 MOE_LAYER_TOL["rtol"]))
        torch.testing.assert_close(a.float(), w_.float(), **MOE_LAYER_TOL)
        log(f"[moe-layer] {name}: gather vs einsum max abs "
            f"{out[name]['max_abs']:.3e}, "
            f"{100 * out[name]['bitwise_share']:.2f} % bitwise, least atol "
            f"at rtol 2^-7 {out[name]['atol_needed']:.3e}")
    out["aux"] = [float(ae), float(ag)]
    if float(ae) != float(ag):
        raise AssertionError(f"moe layer: aux {float(ae)} / {float(ag)}")
    del p, res, x0, cot
    torch.cuda.empty_cache()
    return out


def _register_phase16_configs() -> None:
    """The cut config of phase 16c, registered with the port's own
    ``register`` (16a's gather variant is phase 15's)."""
    import dataclasses
    from repro_torch.configs import get_config, register
    register(dataclasses.replace(get_config("mixtral-8x22b"),
                                 name=MIXTRAL_ARCH, n_layers=2,
                                 attn_impl="pallas"))


class _RouteSpy:
    """Records the top-k expert choices of every MoE call the serving
    path makes (``models.transformer.moe_forward``), on the CPU."""

    def __init__(self):
        from repro_torch.models import transformer as T
        self.T, self.calls = T, []

    def __enter__(self):
        moe = self.T.moe_forward

        def spy(p, x, cfg, *a, **kw):
            logits = x.reshape(-1, x.shape[-1]).float() @ p["router"].float()
            self.calls.append(torch.topk(torch.softmax(logits, -1),
                                         cfg.moe_top_k, -1)[1].cpu())
            return moe(p, x, cfg, *a, **kw)
        self._moe = moe
        self.T.moe_forward = spy
        return self

    def __exit__(self, *exc):
        self.T.moe_forward = self._moe

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def _family_teacher_forced(cfg, params, pre, steps, dev, spy) -> tuple:
    """Prefill logits and the teacher-forced decode logits of ``cfg`` on
    ``dev`` (f32 on the CPU), and each of those steps' MoE choices."""
    from repro_torch.models import transformer as T
    params = {k: t.to(dev) for k, t in params.items()}
    n_pre = cfg.n_prefix if cfg.embed_kind == "prefix" else 0
    s = pre["embeddings" if "embeddings" in pre else "tokens"].shape[1]
    logits_out, routes = [], []
    with torch.inference_mode():
        logits, caches = T.prefill(
            params, {k: v.to(dev) for k, v in pre.items()}, cfg,
            cache_len=n_pre + s + len(steps))
        logits_out.append(logits.float().cpu())
        routes.append(spy.take())
        for i, st in enumerate(steps):
            logits, caches = T.decode_step(
                params, {k: v.to(dev) for k, v in st.items()}, caches,
                n_pre + s + i, cfg)
            logits_out.append(logits.float().cpu())
            routes.append(spy.take())
    return logits_out, routes


def phase_serve_families_small() -> dict:
    """16a: each decoding family beyond the dense token decoders, reduced()
    in f32 with attn_impl="pallas", on the card and on the CPU from one
    seed: the prefill logits and 8 teacher-forced decode steps agree
    within SERVE_SMALL_TOL up to the first step where a token routes to
    another expert (counted each step; the rest reported).  The card's
    prefill runs the f32 flash route once per attention layer."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    sf = SERVE_FAMILY
    out = {}
    for arch in SERVE_FAMILY_ARCHS:
        cfg = dataclasses.replace(get_config(arch), attn_impl="pallas")
        params = T.init_params(cfg, torch.Generator().manual_seed(sf["seed"]))
        g = torch.Generator().manual_seed(1)
        b, s, n = sf["batch"], sf["prompt"], sf["steps"]
        if cfg.embed_kind == "embeddings":
            x = torch.randn(b, s + n, cfg.d_model, generator=g)
            pre, key = {"embeddings": x[:, :s]}, "embeddings"
        else:
            x = torch.randint(0, cfg.vocab, (b, s + n), generator=g,
                              dtype=torch.int32)
            pre, key = {"tokens": x[:, :s]}, "tokens"
        if cfg.embed_kind == "prefix":
            pre["patch_embeds"] = torch.randn(b, cfg.n_prefix, cfg.d_model,
                                              generator=g)
        steps = [{key: x[:, s + i:s + i + 1]} for i in range(n)]
        n_attn = sum(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
        with _RouteSpy() as spy:
            build.reset_launch_counts()
            card, card_routes = _family_teacher_forced(
                cfg, params, pre, steps, torch.device("cuda"), spy)
            counts = build.launch_counts()
            cpu, cpu_routes = _family_teacher_forced(
                cfg, params, pre, steps, torch.device("cpu"), spy)
        want = dict(NO_FLASH, adam_step=0, ef_compress=0, decompress=0,
                    flash_attention=n_attn, **NO_HEAD)
        if counts != want:
            raise AssertionError(f"serve-families {arch}: launch counts "
                                 f"{counts}, expected {want}")
        rerouted = [sum(int((a != b).any(-1).sum()) for a, b in zip(x, y))
                    for x, y in zip(card_routes, cpu_routes)]
        held = next((i for i, r in enumerate(rerouted) if r), len(card))
        errs = []
        for i, (a, c) in enumerate(zip(card, cpu)):
            if not torch.isfinite(a).all():
                raise AssertionError(f"serve-families {arch}: non-finite "
                                     f"logits at step {i}")
            errs.append(float((a - c).abs().max()))
            if i < held:
                torch.testing.assert_close(a, c, **SERVE_SMALL_TOL)
        if held == 0:
            raise AssertionError(f"serve-families {arch}: a token routed "
                                 "differently in the prefill")
        out[arch] = dict(max_abs_err=errs, rerouted=rerouted, held=held,
                         launches=counts)
        log(f"[serve-families] {arch} card vs cpu: prefill + {n} "
            f"teacher-forced decode steps, max abs err "
            + ", ".join(f"{e:.2e}" for e in errs)
            + f"; tokens rerouted a step {rerouted}; held at rtol/atol "
            f"1e-4 through {held} of {len(card)} logits; launches "
            f"flash_attention {counts['flash_attention']}")
    return out


def phase_serve_mamba() -> dict:
    """16b: falcon-mamba-7b at its published width and depth through
    ServeEngine.generate (batch 8 x 2048-token prompts, 32 greedy new
    tokens, random weights from seed 0); launch counts read around exactly
    the measured generate call (no kernel: the SSM has none); then one
    prefill and one decode step under torch.profiler."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import transformer as T
    from repro_torch.serve import GenerationConfig, ServeEngine
    sv = SERVE_MAMBA
    cfg = get_config(sv["arch"])
    gen = torch.Generator(device="cuda").manual_seed(sv["seed"])
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in params.values())
    eng = ServeEngine(cfg, params, device="cuda")
    del params
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (sv["batch"], sv["prompt"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up at the same shapes: cuBLAS handles, the allocator's pools
    eng.generate(prompts, GenerationConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, GenerationConfig(
        max_new_tokens=sv["new_tokens"]))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict(NO_FLASH, adam_step=0, ef_compress=0, decompress=0,
                **NO_HEAD)
    if counts != want:
        raise AssertionError(f"serve-mamba launch counts {counts}, "
                             f"expected {want}")
    tokens = out["tokens"]
    if tuple(tokens.shape) != (sv["batch"], sv["new_tokens"]) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"serve-mamba: bad tokens {tokens.shape}")
    with torch.inference_mode():
        logits, _ = T.prefill(eng.params, {"tokens": prompts}, cfg)
        finite = bool(torch.isfinite(logits).all())
        first_same = float((logits[:, :cfg.vocab].float().argmax(-1)
                            == tokens[:, 0]).float().mean())
    del logits
    if not finite:
        raise AssertionError("serve-mamba: non-finite logits")
    dec = out["decode_ms"]
    med = sorted(dec)[len(dec) // 2]
    stats = dict(
        arch=sv["arch"], n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_inner=cfg.d_inner, n_params=n_params, batch=sv["batch"],
        prompt=sv["prompt"], new_tokens=sv["new_tokens"], setup_s=setup_s,
        prefill_ms=out["prefill_ms"], decode_ms=dec, decode_ms_median=med,
        generate_wall_ms=wall_ms,
        tokens_per_s=sv["batch"] * sv["new_tokens"] / (wall_ms / 1e3),
        decode_tokens_per_s=sv["batch"] / (med / 1e3),
        prefill_tokens_per_s=sv["batch"] * sv["prompt"]
        / (out["prefill_ms"] / 1e3),
        peak_bytes=peak, launches=counts,
        first_token_matches_prefill_argmax=first_same)
    log(f"[serve-mamba] {sv['arch']} ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {n_params} parameters, bf16) batch {sv['batch']} x "
        f"prompt {sv['prompt']}, {sv['new_tokens']} new tokens: prefill "
        f"{out['prefill_ms']:.1f} ms, decode median {med:.2f} ms/step (min "
        f"{min(dec):.2f}, max {max(dec):.2f}), generate wall {wall_ms:.1f} "
        f"ms, {stats['tokens_per_s']:.1f} tokens/s overall, "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s in decode, peak "
        f"memory {peak} bytes, launches {counts}, first token = the prefill "
        f"argmax in {first_same:.3f} of rows, set-up {setup_s:.1f} s")
    stats["profile"] = phase_serve_profile(eng, prompts)
    del eng, prompts, out
    torch.cuda.empty_cache()
    return stats


def phase_serve_mixtral() -> dict:
    """16c: mixtral-8x22b at full width, 2 layers, bf16, attn_impl="pallas",
    through ServeEngine.generate (batch 2 x 5120-token prompts, past the
    window of 4096; 16 greedy new tokens); launch counts read around
    exactly the measured generate call (one windowed wgmma flash launch a
    layer); the kernel against its plain version on layer 0's inputs; the
    last-position prefill logits of the flash route and of
    attn_impl="full" against the model in f32 (see SERVE_MIXTRAL_TOL),
    with the tokens routed differently counted."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import ops as FA
    from repro_torch.kernels.flash_attn import ref as FR
    from repro_torch.models import attention as A
    from repro_torch.models import transformer as T
    from repro_torch.models.common import rms_norm
    from repro_torch.serve import GenerationConfig, ServeEngine
    sv = SERVE_MIXTRAL
    cfg = get_config(sv["arch"])
    gen = torch.Generator(device="cuda").manual_seed(sv["seed"])
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen, device="cuda")
    n_params = sum(t.numel() for t in params.values())
    eng = ServeEngine(cfg, params, device="cuda")
    del params
    torch.cuda.empty_cache()
    prompts = torch.randint(0, cfg.vocab, (sv["batch"], sv["prompt"]),
                            generator=gen, device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eng.generate(prompts, GenerationConfig(max_new_tokens=2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts, GenerationConfig(
        max_new_tokens=sv["new_tokens"]))
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict(NO_FLASH, adam_step=0, ef_compress=0, decompress=0,
                flash_attention_wgmma=cfg.n_layers, **NO_HEAD)
    if counts != want:
        raise AssertionError(f"serve-mixtral launch counts {counts}, "
                             f"expected {want}")
    tokens = out["tokens"]
    if tuple(tokens.shape) != (sv["batch"], sv["new_tokens"]) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        raise AssertionError(f"serve-mixtral: bad tokens {tokens.shape}")
    P = eng.params
    with torch.inference_mode():
        # the kernel on layer 0's serving inputs against its plain version
        p = T._superblock_params(P, cfg)[0]["l0"]
        h = rms_norm(T._inputs_to_h0(P["embed"], {"tokens": prompts}, cfg,
                                     torch.bfloat16), p["norm1"],
                     cfg.norm_eps)
        q, k, v = A._qkv(p["mixer"], h, cfg, torch.arange(
            sv["prompt"], device="cuda")[None, :])
        rep = cfg.n_heads // cfg.n_kv_heads
        q, k, v = (t.transpose(1, 2).contiguous() for t in
                   (q, A._repeat_kv(k, rep), A._repeat_kv(v, rep)))
        o = FA.flash_attention(q, k, v, causal=True, window=cfg.window)
        o_plain = FR.sdpa(q, k, v, causal=True, window=cfg.window)
        kernel = dict(shape=list(q.shape),
                      max_abs_err=float((o.float() - o_plain.float())
                                        .abs().max()),
                      atol_needed=atol_needed(o, o_plain,
                                              FLASH_BF16_TOL["rtol"]),
                      bitwise_share=float((o == o_plain).float().mean()))
        torch.testing.assert_close(o.float(), o_plain.float(),
                                   **FLASH_BF16_TOL)
        del h, q, k, v, o, o_plain
        torch.cuda.empty_cache()
        full = ServeEngine(dataclasses.replace(cfg, attn_impl="full"), P,
                           device="cuda")
        with _RouteSpy() as spy:
            got, caches = T.prefill(P, {"tokens": prompts}, cfg)
            r_flash = spy.take()
            ring = caches["l0"]["k"].shape[2]
            del caches
            ref, _ = T.prefill(full.params, {"tokens": prompts}, full.cfg)
            r_full = spy.take()
            got, ref = got[:, :cfg.vocab].float(), ref[:, :cfg.vocab].float()
            cfg32 = dataclasses.replace(cfg, compute_dtype="float32",
                                        attn_impl="full")
            p32 = {k_: t.float() for k_, t in P.items()}
            del full, eng, P
            torch.cuda.empty_cache()
            exact, _ = T.prefill(p32, {"tokens": prompts}, cfg32)
            r_f32 = spy.take()
            exact = exact[:, :cfg.vocab].float()
            del p32
    torch.cuda.empty_cache()

    def moved(a, b) -> int:
        return sum(int((x != y).any(-1).sum()) for x, y in zip(a, b))
    rerouted = dict(flash_full=moved(r_flash, r_full),
                    flash_f32=moved(r_flash, r_f32),
                    full_f32=moved(r_full, r_f32))
    for name, x in (("flash", got), ("full", ref)):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"serve-mixtral: non-finite {name} logits")
    if ring != cfg.window:
        raise AssertionError(f"serve-mixtral: KV cache of {ring} slots, "
                             f"expected the window's {cfg.window}")
    err_flash = float((got - exact).abs().max())
    err_full = float((ref - exact).abs().max())
    diff = (got - ref).abs()
    outside = float((diff > SERVE_MIXTRAL_TOL["atol"] + SERVE_MIXTRAL_TOL[
        "rtol"] * ref.abs()).float().mean())
    held = rerouted["flash_f32"] == 0 and rerouted["full_f32"] == 0
    if held and err_flash > SERVE_MIXTRAL_ERR_RATIO * err_full:
        raise AssertionError(
            f"serve-mixtral: the flash route's logits are {err_flash:.3e} "
            f"from the f32 model's, the full route's {err_full:.3e}")
    first_same = float((got.argmax(-1) == tokens[:, 0]).float().mean())
    dec = out["decode_ms"]
    med = sorted(dec)[len(dec) // 2]
    stats = dict(
        arch=sv["arch"], n_layers=cfg.n_layers, n_params=n_params,
        batch=sv["batch"], prompt=sv["prompt"], new_tokens=sv["new_tokens"],
        window=cfg.window, setup_s=setup_s, prefill_ms=out["prefill_ms"],
        decode_ms=dec, decode_ms_median=med, generate_wall_ms=wall_ms,
        prefill_tokens_per_s=sv["batch"] * sv["prompt"]
        / (out["prefill_ms"] / 1e3),
        decode_tokens_per_s=sv["batch"] / (med / 1e3), peak_bytes=peak,
        launches=counts, kernel_vs_plain=kernel,
        logits_err_flash_vs_f32=err_flash, logits_err_full_vs_f32=err_full,
        logits_flash_vs_full_max_abs=float(diff.max()),
        logits_flash_vs_full_share_outside_tol=outside,
        logits_abs_max=float(exact.abs().max()), rerouted=rerouted,
        held_against_f32=held, first_token_matches_prefill_argmax=first_same)
    log(f"[serve-mixtral] {sv['arch']} (d {cfg.d_model}, {cfg.n_experts} "
        f"experts top-{cfg.moe_top_k}, window {cfg.window}, {n_params} "
        f"parameters, bf16) batch {sv['batch']} x prompt {sv['prompt']}, "
        f"{sv['new_tokens']} new tokens: prefill {out['prefill_ms']:.1f} ms, "
        f"decode median {med:.2f} ms/step (min {min(dec):.2f}, max "
        f"{max(dec):.2f}), generate wall {wall_ms:.1f} ms, peak memory "
        f"{peak} bytes, launches {counts}, set-up {setup_s:.1f} s")
    log(f"[serve-mixtral] kernel vs plain at {kernel['shape']} window "
        f"{cfg.window}: max abs err {kernel['max_abs_err']:.3e}, least atol "
        f"at rtol 2e-2 {kernel['atol_needed']:.3e}, "
        f"{100 * kernel['bitwise_share']:.1f} % bitwise; last-position "
        f"logits (|f32| up to {stats['logits_abs_max']:.3f}) from the f32 "
        f"model's: flash {err_flash:.3e}, full {err_full:.3e} ("
        + ("held: ratio at most " + str(SERVE_MIXTRAL_ERR_RATIO) if held
           else "not held: a token rerouted")
        + f"); flash vs full max abs {float(diff.max()):.3e}, "
        f"{100 * outside:.1f} % of them outside rtol 2e-2 / atol 5e-3; "
        f"tokens rerouted {rerouted}; first token = the prefill argmax in "
        f"{first_same:.3f} of rows")
    del got, ref, exact, out, prompts
    torch.cuda.empty_cache()
    return stats


def _signs_apart(a: torch.Tensor, b: torch.Tensor) -> int:
    """Sign bits that differ between two packed payloads."""
    return int(np.unpackbits((a.cpu() ^ b.cpu()).numpy()).sum())


def _pack(buf: torch.Tensor, block: int) -> torch.Tensor:
    """The packed signs of a payload (the kernel on the card)."""
    from repro_torch.core.compression import compress_onebit
    return compress_onebit(buf, block)[0].cpu()


def _vision_resnet_small() -> dict:
    """17a for the ResNet: the same 4 onebit steps on the card and on the
    CPU from seed 1's weights and the port's stream."""
    from repro_torch.benchmarks import resnet_convergence as RC
    from repro_torch.models.resnet import init_resnet
    params = init_resnet(torch.Generator().manual_seed(1))
    b1, tw = 0.9, VISION_SMALL["warmup"]
    runs = {}
    for dev in ("cuda", "cpu"):
        x, d, shapes = RC.flat_problem({k: v.to(dev)
                                        for k, v in params.items()})
        st, update = RC.make_update("onebit", x.shape[0], dev, tw)
        losses, pays, snap = [], [], None
        for t in range(VISION_SMALL["steps"]):
            if t == tw:
                snap = (x.cpu(), st.m.cpu(), st.worker_err.cpu())
            loss, g = RC.loss_and_grad(x, d, shapes,
                                       RC._stream(t, device=dev))
            with torch.no_grad():
                if t >= tw:
                    pays.append(_pack(b1 * st.m + (1 - b1) * g
                                      + st.worker_err, RC.BLOCK))
                x, st = update(x, st, g, t)
            losses.append(float(loss))
        runs[dev] = dict(losses=losses, pays=pays, snap=snap, d=d,
                         shapes=shapes)
    # the first compressed payload from the CPU's state after the warmup
    x, m, werr = runs["cpu"]["snap"]
    first = []
    for dev in ("cuda", "cpu"):
        _, g = RC.loss_and_grad(x.to(dev), runs["cpu"]["d"],
                                runs["cpu"]["shapes"],
                                RC._stream(tw, device=dev))
        with torch.no_grad():
            first.append(_pack(b1 * m.to(dev) + (1 - b1) * g
                               + werr.to(dev), RC.BLOCK))
    return _vision_compare("resnet", runs, first, runs["cpu"]["d"])


def _vision_dcgan_small() -> dict:
    """17a for the DCGAN: 4 onebit steps of both networks on the card and
    on the CPU from seed 0's weights and the port's stream; the losses are
    the discriminator's and the generator's before each step."""
    from repro_torch.benchmarks import dcgan_convergence as DC
    from repro_torch.models.dcgan import (d_loss, g_loss,
                                          init_discriminator,
                                          init_generator)
    gen = torch.Generator().manual_seed(0)
    pg0, pd0 = init_generator(gen, DC.Z), init_discriminator(gen)
    tw = VISION_SMALL["warmup"]
    runs = {}
    for dev in ("cuda", "cpu"):
        og = DC._Opt(pg0, "onebit", DC.LR, dev, warmup=tw)
        od = DC._Opt(pd0, "onebit", DC.LR, dev, warmup=tw)
        losses, pays, snap = [], [], None
        for t in range(VISION_SMALL["steps"]):
            z, real = DC._batch(t, dev)
            pg_ = og.params()
            if t == tw:
                snap = (od.x.cpu(), og.x.cpu(), od.st.m.cpu())
            gd = od.grad(lambda pd: d_loss(pd, pg_, real, z))
            with torch.no_grad():
                losses.append(float(d_loss(od.params(), pg_, real, z)))
                if t >= tw:
                    pays.append(_pack(od.cfg.b1 * od.st.m
                                      + (1 - od.cfg.b1) * gd
                                      + od.st.worker_err, DC.BLOCK))
            od.step(gd, t)
            pd_ = od.params()
            og.step(og.grad(lambda pg: g_loss(pg, pd_, z)), t)
        runs[dev] = dict(losses=losses, pays=pays, snap=snap)
    # the discriminator's first compressed payload from the CPU's state
    xd, xg, m = runs["cpu"]["snap"]
    first = []
    for dev in ("cuda", "cpu"):
        od = DC._Opt(pd0, "onebit", DC.LR, dev, warmup=tw)
        og = DC._Opt(pg0, "onebit", DC.LR, dev, warmup=tw)
        od.x, og.x = xd.to(dev), xg.to(dev)
        z, real = DC._batch(tw, dev)
        pg_ = og.params()
        gd = od.grad(lambda pd: d_loss(pd, pg_, real, z))
        with torch.no_grad():
            first.append(_pack(od.cfg.b1 * m.to(dev)
                               + (1 - od.cfg.b1) * gd, DC.BLOCK))
    return _vision_compare("dcgan", runs, first, od.d)


def _vision_compare(tag: str, runs: dict, first: list, d: int) -> dict:
    tw = VISION_SMALL["warmup"]
    card, cpu = runs["cuda"]["losses"], runs["cpu"]["losses"]
    held = range(tw + 1)
    rel = [abs(card[t] - cpu[t]) / abs(cpu[t]) for t in held]
    if not all(math.isfinite(v) for v in card + cpu):
        raise AssertionError(f"vision-small {tag}: non-finite loss {card}")
    if max(rel) > SMALL_LOSS_RTOL:
        raise AssertionError(
            f"vision-small {tag}: card losses {card[:tw + 1]} vs CPU "
            f"{cpu[:tw + 1]}: rel {rel} (rtol {SMALL_LOSS_RTOL})")
    n_bits = 8 * first[0].numel()
    share = _signs_apart(*first) / n_bits
    if share > FAMILIES_SIGN_FLIP_CEILING:
        raise AssertionError(
            f"vision-small {tag}: the first payload's sign bits differ in "
            f"{share:.3e} of {n_bits} from one state (ceiling "
            f"{FAMILIES_SIGN_FLIP_CEILING})")
    free = [_signs_apart(a, b) for a, b in zip(runs["cuda"]["pays"],
                                               runs["cpu"]["pays"])]
    out = dict(d=d, losses_card=card, losses_cpu=cpu, warmup_rel=rel,
               first_payload_bits=n_bits, first_payload_share_apart=share,
               compressed_loss_abs_diff=[abs(a - b) for a, b in
                                         zip(card[tw + 1:], cpu[tw + 1:])],
               free_payload_bits_apart=free)
    log(f"[vision-small] {tag} (d {d}): losses card {card}, CPU {cpu}; "
        f"steps 0-{tw} rel {max(rel):.3e} (held at {SMALL_LOSS_RTOL}); the "
        f"first payload from one state: {share:.3e} of {n_bits} sign bits "
        f"apart (held at {FAMILIES_SIGN_FLIP_CEILING}); reported: later "
        f"loss diff {out['compressed_loss_abs_diff']}, free-running payload "
        f"bits apart {free}")
    return out


def phase_vision() -> dict:
    """Phase 17: the paper's ResNet (Sec. 7.2) and DCGAN (Sec. 7.3) claims
    and the benchmark harness (see the module docstring)."""
    from repro_torch.benchmarks import kernel_micro
    from repro_torch.benchmarks import overlap_check as OC
    from repro_torch.benchmarks import resnet_convergence as RC
    from repro_torch.benchmarks import run as harness
    from repro_torch.kernels import build
    from repro_torch.models.common import strict_f32
    from repro_torch.obs.bench import load_ledger
    t_phase = time.perf_counter()
    out = {}
    with strict_f32():
        out["small"] = {"resnet": _vision_resnet_small(),
                        "dcgan": _vision_dcgan_small()}

    # 17b: the claims through the harness's entries
    verdicts = {"resnet_convergence": lambda r: r["ok"],
                "dcgan_convergence": lambda r: r["equilibrium_ok"]
                and r["onebit_matches_adam"],
                "kernel_micro": kernel_micro.passes}
    claims = {}
    for name in VISION_CLAIMS:
        torch.cuda.empty_cache()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        res = harness.ALL[name](verbose=True, device="cuda")
        secs = time.perf_counter() - t0
        counts = build.launch_counts()
        missing = [k for k in ("ef_compress", "decompress") if not counts[k]]
        if missing:
            raise AssertionError(f"vision {name}: no launch of {missing} "
                                 f"({counts})")
        if not all(math.isfinite(v) for v in _numbers(res)):
            raise AssertionError(f"vision {name}: non-finite result {res}")
        ok = verdicts[name](res)
        claims[name] = dict(result=res, verdict="PASS" if ok else "FAIL",
                            seconds=secs, launches=counts)
        log(f"[vision] {name}: {'PASS' if ok else 'FAIL'} in {secs:.1f} s, "
            f"launches {counts}")
    fd, path = tempfile.mkstemp(suffix=".json", prefix="BENCH_vision_")
    os.close(fd)
    try:
        harness.write_json(path, {k: c["result"] for k, c in claims.items()},
                           list(claims), "cuda")
        n_rec = len(load_ledger(path)["records"])
    finally:
        os.remove(path)
    log(f"[vision] --json ledger: {n_rec} records, read back by load_ledger")
    out["claims"] = claims
    out["ledger_records"] = n_rec

    # 17c: the paper's CIFAR shape
    cifar = {}
    with strict_f32():
        for kind in ("adam", "onebit"):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            build.reset_launch_counts()
            walls = []
            losses = RC.train(kind, VISION_CIFAR["steps"], device="cuda",
                              walls=walls, **{k: VISION_CIFAR[k] for k in
                                              ("widths", "size", "batch")})
            counts = build.launch_counts()
            want = {"ef_compress": kind == "onebit",
                    "decompress": kind == "onebit"}
            if any(bool(counts[k]) != v for k, v in want.items()):
                raise AssertionError(f"vision-cifar {kind}: launches "
                                     f"{counts}")
            finite = [math.isfinite(x) for x in losses]
            first_bad = finite.index(False) if not all(finite) else None
            want_bad = None if kind == "adam" else \
                VISION_CIFAR["onebit_nonfinite_at"]
            n_ok = len(losses) if first_bad is None else first_bad
            if first_bad != want_bad or any(finite[n_ok:]):
                raise AssertionError(
                    f"vision-cifar {kind}: first non-finite loss at step "
                    f"{first_bad}, expected {want_bad} and none finite "
                    f"after it; losses {losses}")
            cifar[kind] = dict(
                step_ms_median=_median(walls[:n_ok]),
                step_ms_median_nonfinite=_median(walls[n_ok:]),
                steps_finite=n_ok, step_ms_first=walls[0],
                step_ms_min=min(walls[:n_ok]),
                around_switch=losses[RC.WARMUP - 2:RC.WARMUP + 5],
                last10=losses[-10:], first=losses[:3],
                peak_bytes=torch.cuda.max_memory_allocated(),
                launches=counts)
            log(f"[vision-cifar] {kind}: widths {VISION_CIFAR['widths']}, "
                f"{VISION_CIFAR['size']} x {VISION_CIFAR['size']}, batch "
                f"{VISION_CIFAR['batch']}, {VISION_CIFAR['steps']} steps "
                f"(T_w {RC.WARMUP}): {n_ok} finite; step median "
                f"{cifar[kind]['step_ms_median']:.2f} ms over them (first "
                f"{walls[0]:.1f}), over the rest "
                f"{cifar[kind]['step_ms_median_nonfinite']}; losses at steps "
                f"{RC.WARMUP - 2}-{RC.WARMUP + 4} "
                f"{cifar[kind]['around_switch']}, last-10 mean "
                f"{sum(losses[-10:]) / 10:.4f}, peak "
                f"{cifar[kind]['peak_bytes']} B, launches {counts}")
    out["cifar"] = cifar

    # 17d: the overlap check on one card
    res = OC.run(device="cuda")
    if res["collectives"] != 0 or res["mesh"] != [1]:
        raise AssertionError(f"vision overlap_check on one card: {res}")
    out["overlap_check"] = dict(skip=True, mesh=res["mesh"],
                                kernels_traced=res["kernels"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[vision] phase 17 in {out['seconds']:.1f} s (budget "
        f"{VISION_BUDGET_S:.0f} s)")
    return out


def _median(xs):
    """The median of ``xs`` (its upper middle), None when empty."""
    return sorted(xs)[len(xs) // 2] if xs else None


def _numbers(res):
    """Every float in a (nested) result."""
    if isinstance(res, dict):
        for v in res.values():
            yield from _numbers(v)
    elif isinstance(res, float):
        yield res


# phase 18: the four-card paths' layouts (arch, tp, the n_dp of the path's
# mesh, the config fields that cut it)
TP_LAYOUTS = {"A": ("internlm2-1.8b", 2, 2, {}),
              "B": ("mixtral-8x22b", 4, 1, {"n_layers": 1})}


def _close_chunked(name: str, got: torch.Tensor, want: torch.Tensor,
                   rtol: float, atol: float, chunk: int = 1 << 27) -> float:
    """``torch.testing.assert_close`` slice by slice (a flat vector of ~1e9
    elements would take its temporaries at full length); returns the max
    abs error."""
    err = 0.0
    for lo in range(0, got.shape[0], chunk):
        a, b = got[lo:lo + chunk], want[lo:lo + chunk]
        torch.testing.assert_close(a, b, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{name} at {lo}: {m}")
        err = max(err, float((a - b).abs().max()))
    return err


def _kernels_at_length(d: int, block: int, seed: int = 0) -> dict:
    """The three optimizer kernels against their plain versions at one
    model rank's padded flat length ``d`` (a four-card path's), block
    ``block``, at phase 3's tolerances: ef_compress's packed signs and
    decompress bitwise, the scales at rtol 1e-6, new_err at rtol 1e-5 /
    atol 1e-6, adam_step (with weight decay) at rtol 1e-5 / atol 5e-7.
    The launch counts are set to 0 just before and read just after."""
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_adam import kernel as FK
    from repro_torch.kernels.fused_adam import ref as FR
    from repro_torch.kernels.onebit import kernel as OK
    from repro_torch.kernels.onebit import ref as OR
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(scale=1.0):
        return torch.randn(d, generator=gen, device="cuda").mul_(scale)

    t0 = time.perf_counter()
    build.reset_launch_counts()
    x, err = randn(), randn(0.1)
    pk, sc, ne = OK.ef_compress_fused(x, err, block)
    pk_r, sc_r, ne_r = OR.ef_compress_fused(x, err, block)
    del x, err
    if not torch.equal(pk, pk_r):
        raise AssertionError(f"ef_compress at d {d}: packed differs in "
                             f"{int((pk != pk_r).sum())} bytes")
    errs = {"ef_compress": max(
        _close_chunked("ef_compress scales", sc, sc_r, 1e-6, 0.0),
        _close_chunked("ef_compress new_err", ne, ne_r, 1e-5, 1e-6))}
    del pk, sc, ne, ne_r
    out = OK.decompress(pk_r, sc_r, block)
    out_r = OR.decompress(pk_r, sc_r, block)
    if not torch.equal(out, out_r):
        raise AssertionError(f"decompress at d {d}: not bitwise the plain "
                             "version")
    errs["decompress"] = 0.0
    del out, out_r, pk_r, sc_r
    torch.cuda.empty_cache()
    xa, m, g = randn(), randn(0.01), randn(0.01)
    v = randn(1e-4).abs_()
    got = FK.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999, 1e-8, 0.01)
    want = FR.adam_step(xa, m, v, g, 1e-3, 0.9, 0.999, 1e-8, 0.01)
    del xa, m, v, g
    errs["adam_step"] = max(
        _close_chunked(f"adam_step {k}", a, b, 1e-5, 5e-7)
        for k, a, b in zip("xmv", got, want))
    del got, want
    torch.cuda.synchronize()
    counts = build.launch_counts()
    torch.cuda.empty_cache()
    return {"max_abs_err": errs,
            "launches": {k: counts[k] for k in errs},
            "seconds": time.perf_counter() - t0}


def phase_tp() -> dict:
    """Phase 18: tensor parallelism's layouts on the card and, with two or
    more cards, the reduced SP / TP parity over NCCL (see the module
    docstring)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.convert import (flat_from_params, params_from_flat,
                                     shard_params, unshard_params)
    from repro_torch.models import transformer as T
    from repro_torch.optim import TwoStageOptimizer
    from repro_torch.state import StateLayout, state_bytes
    from repro_torch.train.step import flat_dim, segment_info
    t_phase = time.perf_counter()
    out = {}
    for name, (arch, tp, n_dp, fields) in TP_LAYOUTS.items():
        cfg = dataclasses.replace(get_config(arch), **fields)
        t0 = time.perf_counter()
        glob = T.init_params(cfg, torch.Generator("cuda").manual_seed(0),
                             device="cuda", tp=tp)
        specs = T.param_specs(cfg)
        local = T.leaf_shapes(cfg, tp)
        flats = [flat_from_params(shard_params(glob, specs, tp, r))
                 for r in range(tp)]
        d = T.flat_size(cfg, tp)
        if any(f.shape[0] != d for f in flats):
            raise AssertionError(f"[tp] {name}: a shard is not {d} long")
        back = unshard_params([params_from_flat(f, local) for f in flats],
                              specs)
        same = all(torch.equal(back[p], glob[p]) for p in glob)
        if not same:
            raise AssertionError(f"[tp] {name}: shard -> unshard is not "
                                 "bitwise the global tree")
        del glob, flats, back
        torch.cuda.synchronize()
        d_pad = flat_dim(cfg, n_dp, 4096, tp)
        ctx = StateLayout(d=d_pad, n_dp=n_dp, n_srv=n_dp,
                          n_segments=segment_info(cfg, d_pad, tp).n,
                          dp_sizes=(n_dp,), tp=tp)
        sb = state_bytes(TwoStageOptimizer().state_slots("replicated"), ctx)
        torch.cuda.empty_cache()
        kern = _kernels_at_length(d_pad, 4096)
        if any(v != 1 for v in kern["launches"].values()):
            raise AssertionError(f"[tp] {name}: kernel launches "
                                 f"{kern['launches']}, one each expected")
        out[name] = dict(arch=arch, tp=tp, n_dp=n_dp, fields=fields,
                         params_global=cfg.param_count(tp),
                         flat_size=d, d_pad=d_pad, state_bytes=sb,
                         kernels=kern,
                         seconds=time.perf_counter() - t0)
        log(f"[tp] 18a {name} {arch}{' x ' + str(fields) if fields else ''}"
            f" at tp {tp}: {cfg.param_count(tp):,} global params; each of "
            f"the {tp} model ranks holds {d:,} (d_pad {d_pad:,} over "
            f"{n_dp} dp), predicted optimizer state {sb / 1e9:.2f} GB a "
            f"rank; shard -> unshard bitwise; at d_pad, block 4096: "
            f"ef_compress, decompress, adam_step against their plain "
            f"versions, max abs err {kern['max_abs_err']}, launches "
            f"{kern['launches']}")
    n = min(torch.cuda.device_count(), 4)
    if n >= 2:
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        import _torch_tp_worker as worker
        workdir = tempfile.mkdtemp()
        try:
            out["reduced_parity"] = worker.reduced_parity(
                workdir, 4 if n == 4 else 2, "nccl", torch.device("cuda"))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        log(f"[tp] 18b reduced SP / TP parity over NCCL on "
            f"{4 if n == 4 else 2} cards: {out['reduced_parity']}")
    else:
        log(f"[tp] 18b ran on {n} card: the NCCL SP / TP parity needs two "
            "or more cards (tests/test_torch_cuda.py -k nccl_tp runs it on "
            "four)")
    out["cards"] = n
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 19: tensor-parallel serving at full width (granite-34b cut in
# depth) and the dry run of phase 5's configuration
TP_SERVE = dict(arch="granite-34b", layers=8, tp=4, batch=8, prompt=2048,
                new_tokens=32, seed=0)


def _one_kv_copy(params: dict, cfg, tp: int) -> dict:
    """The tp = 1 tree of a tp global tree: each kv head's duplicate
    columns dropped."""
    from repro_torch.models.attention import shard_dims
    rep, hd = shard_dims(cfg, tp)[2], cfg.head_dim
    out = dict(params)
    for p, t in params.items():
        if rep > 1 and p.endswith(("mixer.wk", "mixer.wv")):
            n, d = t.shape[:2]
            out[p] = t.reshape(n, d, -1, rep, hd)[:, :, :, 0].reshape(
                n, d, -1).contiguous()
    return out


def phase_tp_serve(main_stats) -> dict:
    """Phase 19 (see the module docstring)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.convert import shard_params, unshard_params
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attn import kernel as FK
    from repro_torch.kernels.flash_attn import ref as FR
    from repro_torch.launch.dryrun import lower_one
    from repro_torch.launch.mesh import DpMesh
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine
    from repro_torch.train.step import make_serve_step
    sv, t_phase = TP_SERVE, time.perf_counter()
    out = {}
    full = get_config(sv["arch"])
    cfg = dataclasses.replace(full, n_layers=sv["layers"],
                              attn_impl="pallas")
    tp, b, s = sv["tp"], sv["batch"], sv["prompt"]
    s_c = s + sv["new_tokens"]
    # 19a: the tp 4 tree, its shards, the caches of a 1 x 4 rank
    t0 = time.perf_counter()
    gen = torch.Generator("cuda").manual_seed(sv["seed"])
    glob = T.init_params(cfg, gen, device="cuda", tp=tp)
    specs = T.param_specs(cfg)
    shards = [shard_params(glob, specs, tp, r) for r in range(tp)]
    local = dict(T.leaf_shapes(cfg, tp))
    if any({p: tuple(t.shape) for p, t in sh.items()} != local
           for sh in shards):
        raise AssertionError("[tp-serve] a shard is not the rank's layout")
    back = unshard_params(shards, specs)
    if not all(torch.equal(back[p], glob[p]) for p in glob):
        raise AssertionError("[tp-serve] shard -> unshard is not bitwise "
                             "the global tree")
    del shards, back
    mesh4 = DpMesh(axes=("dp",), sizes=(1,), groups={}, tp=tp)
    step4 = make_serve_step(cfg, mesh4, InputShape("d", s_c, b, "decode"))
    caches4 = step4.init_caches(dtype=torch.bfloat16)
    cache_shapes = {f"{n}.{k}": list(t.shape) for n, leaves in
                    caches4.items() for k, t in leaves.items()}
    want_k = [sv["layers"], b, s_c, 1, cfg.head_dim]
    if cache_shapes != {"l0.k": want_k, "l0.v": want_k}:
        raise AssertionError(f"[tp-serve] rank caches {cache_shapes}")
    del caches4
    full_caches = T.init_caches(full, b, s_c, torch.bfloat16, "meta", tp=tp)
    rank_cache_bytes = sum(
        t.numel() // tp * t.element_size()
        for leaves in full_caches.values() for t in leaves.values())
    rank_weight_bytes = 2 * T.flat_size(full, tp)
    out["a"] = dict(global_params=cfg.param_count(tp),
                    rank_params=T.flat_size(cfg, tp),
                    rank_cache_shapes=cache_shapes,
                    full_depth_rank_weight_bytes_bf16=rank_weight_bytes,
                    full_depth_rank_cache_bytes=rank_cache_bytes,
                    full_depth_rank_params=T.flat_size(full, tp),
                    seconds=time.perf_counter() - t0)
    log(f"[tp-serve] 19a {sv['arch']} x {sv['layers']} layers at tp {tp}: "
        f"{cfg.param_count(tp):,} global params, {T.flat_size(cfg, tp):,} "
        f"a model rank; shard -> unshard bitwise; a rank's caches "
        f"{cache_shapes}; at full depth ({full.n_layers} layers) a card "
        f"holds {rank_weight_bytes / 1e9:.2f} GB of bf16 weights and "
        f"{rank_cache_bytes / 1e9:.2f} GB of caches at batch {b} x {s_c}")
    # 19b: tp 1 through make_serve_step, bitwise the direct calls
    t0 = time.perf_counter()
    eng = ServeEngine(cfg, _one_kv_copy(glob, cfg, tp), device="cuda")
    del glob
    torch.cuda.empty_cache()
    params = eng.params
    one = DpMesh(axes=("dp",), sizes=(1,), groups={})
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=gen,
                            device="cuda", dtype=torch.int32)
    pstep = make_serve_step(cfg, one, InputShape("p", s, b, "prefill"))
    dstep = make_serve_step(cfg, one, InputShape("d", s_c, b, "decode"))
    pstep(params, {"tokens": prompts})            # warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t1 = time.perf_counter()
    logits = pstep(params, {"tokens": prompts})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t1) * 1e3
    counts = build.launch_counts()
    want = {"ef_compress": 0, "decompress": 0, "adam_step": 0,
            "flash_attention": 0, "flash_attention_wgmma": sv["layers"],
            "flash_attention_wide": 0, **NO_HEAD}
    if counts != want:
        raise AssertionError(f"[tp-serve] prefill launches {counts}, "
                             f"expected {want}")
    with torch.inference_mode():
        ref, caches = T.prefill(params, {"tokens": prompts}, cfg,
                                cache_len=s_c)
    if not torch.equal(logits, ref):
        raise AssertionError("[tp-serve] the serve step's prefill is not "
                             "bitwise prefill")
    tok = logits[:, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
    with torch.inference_mode():
        mine = {n: {k: t.clone() for k, t in lv.items()}
                for n, lv in caches.items()}
        ref2, _ = T.decode_step(params, {"tokens": tok}, caches, s, cfg)
    got2, _ = dstep(params, {"tokens": tok}, mine, s)
    if not torch.equal(got2, ref2) or not bool(torch.isfinite(got2).all()):
        raise AssertionError("[tp-serve] the serve step's decode is not "
                             "bitwise decode_step")
    del caches, mine, ref, ref2, got2, logits
    q, k, v = (torch.randn((b, cfg.n_heads // tp, s, cfg.head_dim),
                           generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    got = FK.flash_attention(q, k, v, causal=True)
    want_o = FR.sdpa(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want_o.float(), **FLASH_BF16_TOL)
    flash_err = float((got.float() - want_o.float()).abs().max())
    del q, k, v, got, want_o, eng, params
    torch.cuda.empty_cache()
    out["b"] = dict(prefill_ms=prefill_ms, launches=counts,
                    flash_rank_shape=[b, cfg.n_heads // tp, s, cfg.head_dim],
                    flash_max_abs_err=flash_err,
                    seconds=time.perf_counter() - t0)
    log(f"[tp-serve] 19b tp 1 through make_serve_step, batch {b} x prompt "
        f"{s}: prefill {prefill_ms:.1f} ms, bitwise prefill / decode_step; "
        f"launches {counts}; the wgmma route at a tp {tp} rank's shape "
        f"{out['b']['flash_rank_shape']} against its plain version: max "
        f"abs err {flash_err:.3e} ({FLASH_BF16_TOL})")
    # 19c: the dry run of phase 5's configuration beside its measurements
    t0 = time.perf_counter()
    r = lower_one(MAIN["arch"], InputShape("phase5", MAIN["seq"],
                                           MAIN["batch"], "train"),
                  stage="compressed", mesh_override="1x1")
    rl = r["roofline"]
    busy = main_stats["profile"]["compressed"]["device_busy_ms"]
    out["c"] = dict(traced_peak_bytes=r["memory"]["peak_bytes"],
                    traced_arg_bytes=r["memory"]["arg_bytes"],
                    measured_peak_bytes=main_stats["peak_bytes"],
                    roofline=rl, bound_ms=1e3 * max(
                        rl["t_compute_s"], rl["t_memory_s"],
                        rl["t_collective_s"]),
                    device_busy_ms=busy,
                    predicted=r["memory_ledger"]["predicted"],
                    seconds=time.perf_counter() - t0)
    log(f"[tp-serve] 19c dry run of phase 5 (bert-large {MAIN['batch']} x "
        f"{MAIN['seq']}, 1 x 1, compressed) in {r['trace_s']} s: traced "
        f"peak {r['memory']['peak_bytes'] / 1e9:.3f} GB against phase 5's "
        f"max_memory_allocated {main_stats['peak_bytes'] / 1e9:.3f} GB; "
        f"roofline compute {rl['t_compute_s'] * 1e3:.2f} ms, memory "
        f"{rl['t_memory_s'] * 1e3:.2f} ms, collective "
        f"{rl['t_collective_s'] * 1e3:.2f} ms ({rl['bottleneck']}) against "
        f"phase 6's compressed step device busy {busy:.1f} ms; kernels "
        f"{rl['kernels']}")
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 20: the micro of overlap_check --bwd (the reference's sizes)
OVERLAP_BWD = dict(block=512, n_buckets=2, n_layers=4, width=64)


def _close20(tag: str, got: torch.Tensor, want: torch.Tensor, rtol: float,
             atol: float) -> float:
    got, want = got.cpu(), want.cpu()
    if not torch.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"[overlap-bwd] {tag}: card vs CPU off by "
                             f"{float((got - want).abs().max()):.3e} "
                             f"(rtol {rtol}, atol {atol})")
    return float((got - want).abs().max())


def phase_overlap_bwd() -> dict:
    """Phase 20: overlap_check --bwd's micro on the card against the CPU,
    its kernels counted, and run_bwd on one card (see the module
    docstring)."""
    import io
    from contextlib import redirect_stdout
    from repro_torch.benchmarks import overlap_check as OC
    from repro_torch.kernels import build
    from repro_torch.optim.compressors import IdentityCompressor
    ob, t_phase = OVERLAP_BWD, time.perf_counter()
    kw = dict(mesh_shape=(1,), block=ob["block"], n_buckets=ob["n_buckets"],
              n_layers=ob["n_layers"], width=ob["width"])
    ident = IdentityCompressor(block_size=ob["block"])
    d = ob["n_layers"] * ob["width"] ** 2
    g_card = OC.build_bwd_exchange(comp=ident, device="cuda", **kw)[0]
    g_cpu = OC.build_bwd_exchange(comp=ident, device="cpu", **kw)[0]
    out = {"grad_max_abs_err": _close20("chain gradient", g_card, g_cpu,
                                        1e-5, 1e-7)}
    w = ob["width"]
    grads = [g_cpu[i * w * w:(i + 1) * w * w].reshape(w, w).numpy()
             for i in range(ob["n_layers"])]
    errs = {}
    for tag, extra in (("landed", dict(grads=grads)), ("backward", {})):
        build.reset_launch_counts()
        t0 = time.perf_counter()
        card = OC.build_bwd_exchange(device="cuda", **kw, **extra)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = build.launch_counts()
        cpu = OC.build_bwd_exchange(device="cpu", **kw, **extra)
        errs[tag] = max(
            _close20(f"{tag} out", card[0], cpu[0], 1e-6, 0.0),
            _close20(f"{tag} worker_err", card[1], cpu[1], 1e-5, 1e-6),
            _close20(f"{tag} server_err", card[2], cpu[2], 1e-5, 1e-6))
        nb = ob["n_buckets"]
        want = {"adam_step": 0, "ef_compress": 2 * nb, "decompress": 2 * nb}
        got = {k: counts[k] for k in want}
        if got != want:
            raise AssertionError(f"[overlap-bwd] {tag}: launches {got}, "
                                 f"expected {want}")
        if not all(bool(torch.isfinite(t).all()) for t in card):
            raise AssertionError(f"[overlap-bwd] {tag}: non-finite output")
        out[tag] = {"max_abs_err": errs[tag], "launches": counts,
                    "host_ms": ms}
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        res = OC.run_bwd((1,), ob["block"], ob["n_buckets"], device="cuda")
    text = buf.getvalue()
    if "[SKIP] one rank: no collective" not in text or res["pairs"] != 0:
        raise AssertionError(f"[overlap-bwd] run_bwd on one card: {text}")
    # 4 forward matmuls, and 7 in backward (no input gradient for x)
    if res["n_dots"] < 7:
        raise AssertionError(f"[overlap-bwd] run_bwd found {res['n_dots']} "
                             "backward matmul kernels, at least 7 expected")
    out["run_bwd"] = {"pairs": res["pairs"], "n_dots": res["n_dots"],
                      "backward_passes": res["ranks"][0]["backward_passes"],
                      "seconds": time.perf_counter() - t0}
    out["d"] = d
    out["seconds"] = time.perf_counter() - t_phase
    counts = {k: out["backward"]["launches"][k]
              for k in ("adam_step", "ef_compress", "decompress")}
    log(f"[overlap-bwd] micro (d {d}, {ob['n_buckets']} buckets, block "
        f"{ob['block']}) card vs CPU: chain gradient max abs err "
        f"{out['grad_max_abs_err']:.3e}; 1-bit exchange of landed "
        f"gradients {errs['landed']:.3e}, of the backward pass "
        f"{errs['backward']:.3e} with launches {counts}; "
        f"run_bwd on one card: {text.strip().splitlines()[-1].strip()} "
        f"({res['n_dots']} backward matmul kernels found by correlation); "
        f"phase 20 in {out['seconds']:.1f} s")
    return out


def _x_sha256(x: torch.Tensor) -> str:
    return hashlib.sha256(x.detach().cpu().contiguous().numpy().data
                          ).hexdigest()


def _remat_dots_child(out_path: str) -> None:
    """Phase 21's run, in a process of its own (see ``phase_remat_dots``)."""
    import dataclasses
    from repro_torch.configs import get_config, register
    from repro_torch.kernels import build
    from repro_torch.launch.train import run
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    register(dataclasses.replace(get_config(MAIN["arch"]), name=DOTS_ARCH,
                                 remat_policy="dots"))
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    res = run(device="cuda", **dict(MAIN, arch=DOTS_ARCH))
    counts = build.launch_counts()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    hist, state = res["history"], res["state"]
    w = MAIN["warmup_steps"]
    out = {"launches": counts, "run_s": run_s, "peak_bytes": peak,
           "losses": [h["loss"] for h in hist],
           "stages": [h["stage"] for h in hist],
           "warmup_step_ms": [h["ms"] for h in hist[:w]],
           "compressed_step_ms": [h["ms"] for h in hist[w:]],
           "x_sha256": _x_sha256(state.x)}
    out["fwd_bwd_ms"] = _fwd_bwd_in_turns(state.x)
    out["profile"] = phase_profile(state)
    with open(out_path, "w") as f:
        json.dump(out, f)


def _fwd_bwd_in_turns(x: torch.Tensor) -> dict:
    """Host ms of one forward and backward pass of the main path's model
    over ``x``, under "block" and "dots" in turns (block, dots, dots,
    block), each ended by a synchronise: the two policies in one
    process."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.data import SyntheticStream
    from repro_torch.models.transformer import Transformer, loss_fn
    base = get_config(MAIN["arch"])
    batch = SyntheticStream(
        base, InputShape("turns", MAIN["seq"], MAIN["batch"], "train"),
        seed=2, device="cuda").batch_at(0)
    g = torch.zeros_like(x)
    out = {"block": [], "dots": []}
    for pol in ("block", "dots", "dots", "block"):
        model = Transformer(dataclasses.replace(base, remat_policy=pol), x)
        model.bind_grads(g)
        g.zero_()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_fn(model, batch)[0].backward()
        torch.cuda.synchronize()
        out[pol].append((time.perf_counter() - t0) * 1e3)
    return out


def phase_remat_dots(stats: dict, main_x_sha: str) -> dict:
    """Phase 21: phase 5's run under ``remat_policy="dots"`` in a spawned
    process, held bitwise to phase 5 and printed beside phases 5 and 6
    (see the module docstring)."""
    import multiprocessing
    t0 = time.perf_counter()
    path = os.path.join(tempfile.mkdtemp(), "remat_dots.json")
    torch.cuda.empty_cache()
    proc = multiprocessing.get_context("spawn").Process(
        target=_remat_dots_child, args=(path,))
    proc.start()
    proc.join()
    if proc.exitcode != 0:
        raise AssertionError(f"[remat-dots] the run's process exited "
                             f"{proc.exitcode}")
    with open(path) as f:
        out = json.load(f)
    shutil.rmtree(os.path.dirname(path), ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    if out["launches"] != EXPECTED_LAUNCHES:
        raise AssertionError(f"[remat-dots] launch counts "
                             f"{out['launches']}, expected "
                             f"{EXPECTED_LAUNCHES}")
    if out["losses"] != stats["losses"]:
        raise AssertionError(f"[remat-dots] losses {out['losses']} are not "
                             f"phase 5's {stats['losses']}")
    out["x_bitwise_main"] = out["x_sha256"] == main_x_sha
    if not out["x_bitwise_main"]:
        raise AssertionError("[remat-dots] the final x is not phase 5's")
    mm = "matmul (cuBLAS)"
    for tag, r in (("phase 5/6 block", stats), ("phase 21 dots", out)):
        comp = r["profile"]["compressed"]
        log(f"[remat-dots] {tag}: warmup step ms {r['warmup_step_ms']}, "
            f"compressed step ms {r['compressed_step_ms']}, peak "
            f"{r['peak_bytes']} bytes; profiled compressed step: matmul "
            f"{comp['by_group_ms'].get(mm, 0.0):.3f} device ms over "
            f"{comp['by_group_kernels'].get(mm, 0)} kernels, "
            f"{comp['n_kernels']} kernels, busy "
            f"{comp['device_busy_ms']:.1f} of {comp['wall_ms']:.1f} ms")
    log(f"[remat-dots] one forward and backward pass in turns in phase "
        f"21's process, host ms: block {out['fwd_bwd_ms']['block']}, dots "
        f"{out['fwd_bwd_ms']['dots']}")
    counts = {k: out["launches"][k]
              for k in ("adam_step", "ef_compress", "decompress")}
    log(f"[remat-dots] losses and final x bitwise phase 5's, launches "
        f"{counts}; phase 21 in {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.train.step import flat_dim
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    phase_build()
    d_pad = flat_dim(get_config(MAIN["arch"]), 1, MAIN["block_size"])
    log(f"[kernels] main-path d_pad = {d_pad}")
    entries = phase_kernels(d_pad, MAIN["block_size"])
    phase_small()
    counts, stats, state = phase_main()
    # phase 6c is held to the state after phase 5's sixth step, which
    # phase 6's profiled steps move on
    main_state = {"x": state.x.cpu()}
    main_state.update({k: state.opt[k].cpu() for k in PIPE_STATE})
    stats["profile"] = phase_profile(state)
    del state
    torch.cuda.empty_cache()
    remat_dots = phase_remat_dots(stats, _x_sha256(main_state["x"]))
    phase_family_small()
    family = phase_family(stats["losses"])
    torch.cuda.empty_cache()
    phase_pipeline_small()
    pipe = phase_pipeline(stats["losses"], main_state)
    family["pipeline"] = pipe
    f32, wgmma, wide = phase_flash()
    phase_serve_small()
    serve_counts, serve_stats, eng, prompts = phase_serve_main()
    serve_stats["profile"] = phase_serve_profile(eng, prompts)
    del eng, prompts
    torch.cuda.empty_cache()
    serve_f32 = phase_serve_f32()
    oracles = phase_oracles()
    claims = phase_claims()
    torch.cuda.empty_cache()
    plan = phase_plan(stats["losses"], main_state, stats)
    torch.cuda.empty_cache()
    obs = phase_obs(stats["losses"], main_state, stats, family)
    del main_state
    torch.cuda.empty_cache()
    _register_phase15_configs()
    families = {"small": phase_families_small()}
    families["main"] = phase_families_main()
    families["moe_layer"] = phase_moe_layer()
    _register_phase16_configs()
    serve_families = {"small": phase_serve_families_small()}
    serve_families["mamba"] = phase_serve_mamba()
    serve_families["mixtral"] = phase_serve_mixtral()
    torch.cuda.empty_cache()
    vision = phase_vision()
    torch.cuda.empty_cache()
    tp = phase_tp()
    torch.cuda.empty_cache()
    tp_serve = phase_tp_serve(stats)
    torch.cuda.empty_cache()
    overlap_bwd = phase_overlap_bwd()
    for e in entries:
        e["launches"] = counts[e["name"]]
        e["launches_family"] = {tag: f["launches"][e["name"]]
                                for tag, f in family.items()}
    for e in (f32, wgmma, wide):
        # the main path of each route: serving in bf16 (phase 9) for the
        # wgmma kernel, in f32 (phase 9b) for the f32 route; no path has
        # D > 256
        e["launches"] = (serve_f32["launches"] if e is f32
                         else serve_counts)[e["name"]]
        e["launches_serve_bf16"] = serve_counts[e["name"]]
        e["launches_serve_f32"] = serve_f32["launches"][e["name"]]
        e["launches_family"] = {tag: f["launches"][e["name"]]
                                for tag, f in family.items()}
        e["launches_tp_serve_prefill"] = tp_serve["b"]["launches"][e["name"]]
        entries.append(e)
    for e in entries:
        e["kernel_ms"] = e["ms"]
        e["launches_oracles"] = oracles["launches"][e["name"]]
        e["launches_claims"] = {part: c["launches"][e["name"]]
                                for part, c in claims.items()}
        e["launches_plan"] = plan["launches"][e["name"]]
        e["launches_obs"] = obs["a"]["launches"][e["name"]]
        e["launches_families"] = families["main"]["launches"][e["name"]]
        e["launches_serve_mamba"] = \
            serve_families["mamba"]["launches"][e["name"]]
        e["launches_serve_mixtral"] = \
            serve_families["mixtral"]["launches"][e["name"]]
        e["launches_overlap_bwd"] = \
            overlap_bwd["backward"]["launches"][e["name"]]
        e["launches_remat_dots"] = remat_dots["launches"][e["name"]]
        e["launches_vision"] = dict(
            {k: c["launches"][e["name"]]
             for k, c in vision["claims"].items()},
            **{f"cifar_{k}": c["launches"][e["name"]]
               for k, c in vision["cifar"].items()})
    print(json.dumps({"main_path": stats}))
    print(json.dumps({"family_path": {k: v for k, v in family.items()
                                      if k != "pipeline"}}))
    print(json.dumps({"pipeline_path": pipe}))
    print(json.dumps({"serve_path": serve_stats}))
    print(json.dumps({"serve_f32_path": serve_f32}))
    print(json.dumps({"oracles": oracles}))
    print(json.dumps({"claims": claims}))
    print(json.dumps({"plan": plan}))
    print(json.dumps({"obs": obs}))
    print(json.dumps({"families": families}))
    print(json.dumps({"serve_families": serve_families}))
    print(json.dumps({"vision": vision}))
    print(json.dumps({"tp": tp}))
    print(json.dumps({"tp_serve": tp_serve}))
    print(json.dumps({"overlap_bwd": overlap_bwd}))
    print(json.dumps({"remat_dots": remat_dots}))
    print(json.dumps({"kernels": entries}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
