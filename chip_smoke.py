#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--quick] [--json PATH]

Phases, each of which exits non-zero when it fails:

1. environment — the card's name and power limit (``nvidia-smi``) and its
   compute capability, which must be 9.x (Hopper);
2. build — every kernel of the main paths (K1 fused step: K4 gmem's
   body in place, K2 2.5D
   streaming, K3 temporal blocking at k=2 and k=3, K5 semi-stencil, and
   the per-application kernels of ``st.map``: K4 gmem/f4/smem, K2's and
   K5's builds with a destination, for ``star3d4r`` and acoustic ISO, and
   for a Jacobi kernel that reads its output off-center; one for every
   shape and region phase 3 runs them at and phase 7's seven regions under
   f4, since f4's load path and smem's staging path follow from the grids'
   pitches and the region), their bf16 builds (K3 at k=2), K6 (causal
   conv1d) and K7 (flash decode attention: its split and combine passes),
   built from ``src`` with one ``nvcc`` per source, all started together
   (K2's and K3's sources depend on the buffers' pitches, their staging
   path: one for every shape and type they run at, and K2's 512³ builds
   again with granules in place of the TMA); for every K1, K4 gmem, f4,
   smem, K2 and K3 build its path (K1/K4 gmem: its points a lane and each
   read grid's pair or single-cell loads; f4: each grid's rows
   aligned at plan time or at run time; smem, K2, K3: each staged grid
   copied by TMA or by 4-byte ``cp.async`` granules), its tile, shared
   bytes and ``ptxas`` registers and spills;
3. kernels — each kernel against its plain PyTorch version on the card,
   after one launch (K3: k=2 and k=3, both reading buffers left intact),
   at a block-multiple shape (64³), a ragged one (61×70×133) and the
   main-path shape (512³, K3 at k=2 only); time per step of kernel and
   plain version at 512³ (CUDA events; K3's launch time divided by k,
   and the launch time),
   and for ``star3d4r`` of the one library call that computes the same
   update (``conv3d`` in f32 with the star as a dense 9³ weight); then
   each per-application kernel against its plain version after one
   application at the same shapes, at a sub-region whose z-start is not a
   multiple of 4, and for the Jacobi kernel (outputs into a destination
   buffer), with its time per application at 512³; every stencil source
   built for bf16 grids against its plain version at the two small shapes
   (within one bf16 ulp of max(1, |plain|); K3 at k=2 and k=3), K4 gmem,
   f4, smem and shift also at the sub-region and 512³, and K1 (gmem), K2
   (shift), K3 (k=2: per step and per launch) and K4 gmem/f4/smem/shift
   in bf16 at 512³ with their times (and ``conv3d`` on bf16 grids for
   ``star3d4r``); K2's TMA and granule builds at 512³, f32 and bf16,
   against each other and timed in turns; K6 in bf16 and f32 at
   the serving decode shape ``[4, 4, 4096]``, a prefill-sized
   ``[4, 2048, 4096]``, the training path's ``[2, 4099, 4096]`` and a
   ragged ``[3, 1001, 4100]``, each at widths 1 and 4 and in every build
   that takes the tensors (the vector build where ``build_of`` picks it,
   the lane build everywhere), bit for bit, timed in the build
   ``build_of`` picks (bf16 at every shape, f32 at the prefill and
   training shapes); K6's gradient (``CausalConv1dFn``: K6 on the
   reversed cotangent, the flips, the dw reduction) at the training shape
   in bf16 against ``torch.autograd.grad`` of its plain version and
   ``aten.convolution_backward``, each piece timed; and K7 in bf16 at RecurrentGemma's decode shape (B=8, H=16, K=1,
   hd=256, S=2048), at B=1 and at a GQA one (H=8, K=2, hd=128, S=1000),
   with random lengths and with lengths 0, 1, S and one past a split
   boundary, each against its plain version after one call (its split
   pass's partials and its combine pass each against theirs too), with
   the time of kernel, plain version and one library call (``F.conv1d``
   with ``groups=W``; ``F.scaled_dot_product_attention`` on the expanded
   cache; K6 and K7 as device times of CUDA graphs) at B=8 and B=1;
4. main path — at 512³ f32 interior through ``st.launch(backend=
   st.hopper(...))``: templates gmem (K1), shift (K2), shift with
   ``time_block=2`` (K3) and semi (K5); ``star3d4r`` 100 steps, acoustic
   ISO 100 steps with ``fuse_steps=10`` and source injection in
   ``between``; the launch counters must show exactly the path's kernel
   (K3: 50 launches, the others 100), the fields must be finite and
   match ``st.torch()`` on the card over the same steps; K1 on acoustic is
   timed again on the fields its 100 steps left (a wave around the
   source) beside phase 3's random fields;
5. absorbing boundary — acoustic ISO as in 4 at 64³, where the wave
   enters the PML within the 100 steps, against ``st.torch()``, plus K3
   with ``fuse_steps=7`` (3 K3 launches and one K2 remainder step a
   window);
6. per-application main path — at 512³ f32 under templates gmem, f4, smem
   (K4), shift (K4 streaming) and semi (K5): ``star3d4r`` as 100 ``st.map``
   applications with the ``(u.data, v.data)`` swap, acoustic ISO through
   ``acoustic.run(iters=100, pml_width=10)`` with the source injected every
   step; exactly 100 launches of the path's kernel and no other, fields
   within 2e-5 of their max of the same loop under ``st.torch()``;
7. regions and Listing 1 — one ``star3d4r`` application at 512³ as the
   seven regions of ``regions.seven_region(shape, 10)`` under gmem and f4
   against one whole-interior ``st.map`` under the same template, and that
   against one under ``st.torch()``; the paper's Listing 1 (2D
   ``star2d4r``, 50 ``st.map`` steps at 256² under ``st.cuda(
   computeCapability="9.0", threadsPerBlock=(8, 128), template="gmem")``)
   against ``st.torch()`` within 1e-5 of the field's max;
8. serving — ``recurrentgemma-9b`` at its published widths and depth (38
   layers, bf16 compute, f32 parameters drawn from a seed on the card)
   through ``BatchServer``: 8 requests of 4–16 prompt tokens (numpy seed),
   ``batch_size=4``, 8 new tokens each, greedy; K6 must launch exactly 26
   times a decode step (once per recurrent layer), its plain version and
   every other kernel never; tokens in range; the first 4 decode steps'
   logits finite and within 2e-2 of their max of the same steps with
   ``use_kernel_conv=False``; tokens/s, ms per decode step and request
   latency; then K7 against the model's ``_sdpa`` on the last wave's
   local-attention cache with ``lengths = min(pos + 1, Sc)`` (K7 is
   standalone, as in the JAX package: nothing on the serving path calls
   it); last, 4 decode steps under ``torch.profiler``: the kernels' device
   time a step and K6's share of it;
9. training — ``recurrentgemma-9b`` at its published widths (d_model 4096,
   rnn 4096, d_ff 12288, vocab 256000, 16 heads of 256, local window 2048,
   ``attn_chunk`` 1024, ``logits_chunk`` 256, remat "full"), depth cut to
   3 layers (one rec, rec, attn cycle), f32 parameters from a seed on the
   card, batch 2 x seq 4096 of ``train/data.py`` tokens: the first step's
   loss and ``conv_w`` gradients with K6 and with its plain version
   (loss within 1e-3 of it, gradients within 3e-2 of their max), then 4
   AdamW steps of ``train_loop.make_train_step`` as the main path (K6
   exactly 3 launches a recurrent layer a step: forward, recompute, dx;
   nothing else; finite losses, params and moments), ms a step, tokens/s,
   peak memory; one more step under ``torch.profiler``: device time, K6's
   and the flips', the kernels that take the most;
10. autotune — ``star3d4r`` and acoustic ISO at 512³ f32 through
   ``autotune.tune`` (``steps=16``, ``iters=1``): in two stages
   (``top_k=3``, with the tune cache ``build/autotune_cache`` emptied
   first, so cold: the cost model's probes, the shortlist's build wave and
   its measurements timed apart), then exhaustively (every candidate of
   ``default_space`` over fuse 1/4/16 and time_block 1/2/4, deduplicated
   on the builds it launches); each class's calibrated rate, every
   candidate's predicted and measured seconds in predicted order, both
   ``rank_error``s and the pruned count; the two-stage winner may take at
   most 1.15× the exhaustive winner's time; the shortlists one rate for
   every hopper class and (acoustic) ``star3d4r``'s rates would give, with
   their best measured time; then each main path of phase 4 (100 steps;
   acoustic with ``fuse_steps=10`` and its source in ``between``) through
   ``st.launch(autotune=True, autotune_cache=...)``, an in-process hit,
   and again after the in-process cache and the cost models are dropped,
   a disk hit: ``MEASURE_COUNT`` unchanged, exactly the chosen kernel's
   launches, the fields within 2e-5 of their max of ``st.torch()``,
   steps/s beside phase 4's best fixed build;
11. batched scenarios and the adjoint — (a) acoustic ISO at 512³ f32 with
   ``batch=4`` shots, each its own source position and model (the
   background with a slow blob beside its source), 100 steps with
   ``fuse_steps=10`` and the sources in ``between``, under K1, K2, K3
   (k=2) and K5: exactly the unbatched path's launches (one launch
   advances every shot), each shot equal bit for bit to its own unbatched
   run under the same build and within 2e-5 of its max of the batched
   ``st.torch()`` run; steps/s and scenario-steps/s beside phase 4's
   unbatched steps/s; ``star3d4r`` with ``batch=2`` under K2 the same way;
   per-scenario ``(B, NS)`` scalars (a dt a scenario) at the small shapes,
   one launch of K1/K2/K3/K5 against its plain version; (b) the gradient
   of a misfit at 512³ (one shot, 100 steps, the loss the sum of squares
   of the final ``p1`` minus the one observed on the true model) with
   respect to p0, p1, vp² and dt through ``st.differentiable_timeloop``
   under ``st.hopper(template="gmem")``, default schedule (fuse 10, 10
   checkpoints): ``CHECKPOINT_STATS`` as scheduled, K1 launched exactly
   200 times (forward and the backward pass's step-by-step replay), the
   gradients within 1e-3 of their max of the same adjoint under
   ``st.torch()``, the vp² gradient along the blob within 2e-2 of a
   central difference; forward seconds, backward seconds split into
   replay, recompute and VJP, and peak device memory;
12. resilience — (a) acoustic ISO at 512³ f32 (PML 10, 100 steps, windows
   of 10, the source in ``between``) on phase 10's tuned acoustic build
   through ``timeloop.run_resilient`` into a directory under ``build/``
   (removed afterwards), a save every 5 windows, failures injected before
   windows 3 and 7: the fields bit for bit an uninterrupted ``engine.run``
   from the same initial fields, exactly 2 restarts (each the injected
   failure), the launches of the windows run (replays included); then a
   fresh run of 50 steps and one of 100 steps on the same directory
   (no hook: a run that ends at 50 does not inject there), bit for bit
   the uninterrupted run, the second launching only the last 5 windows;
   the uninterrupted and resilient seconds, bytes and seconds of each
   save (device to host, files) and restore, windows replayed; (b) the
   gradient at 256³ (100 steps, windows of 10, K1) through
   ``run_resilient(loss=)`` with a save every 6 of its 21 units (at most
   4 saves), failures before a forward unit and a backward segment: value
   and every gradient bit for bit the uninterrupted ``differentiable_run``
   on the same engine; (c) ``launch.train``'s step on
   ``configs.tiny(recurrentgemma-9b)`` at the CLI's smoke size, 6 steps, a
   save every 2, a failure before step 3 through ``run_with_restarts``:
   losses and state equal to an uninterrupted run's (bit for bit when two
   uninterrupted runs agree bit for bit, else within their difference),
   K6's launches those of the steps run; ``launch.train --ckpt-dir`` on
   the card;
13. stencil serving — ``SimServer`` on the card: 16 ``star3d4r`` requests,
   interior extents drawn from a seed in 129–256 (one 256³ bucket), steps
   in 20–100 and one of 0, ``batch_cap=8``, ``fuse_window=10`` (two waves
   of the masked batched ``st.torch()`` window, no kernel launched): each
   result within ``rtol=1e-5, atol=1e-6`` of its own serial unbatched
   ``st.torch()`` run at its true shape, the first request also within
   2e-5 of its max of its run under K2; requests/s, seconds a wave,
   latency p50/max, peak device memory a wave; then a server with
   ``autotune_cache=`` (a directory under ``build/``) cold and warm (the
   in-process caches and cost models dropped) on the first 8 requests:
   the cold one measures candidates, the warm one none, with the same
   fuse window and results;
14. distributed — the distributed stencil layer on a (2, 2) mesh of the
   card over ("data", "model"), axes 0 and 1 split, every shard on
   ``cuda:0``: (a) 20 ``st.map`` of star3d4r at 512³ under
   ``inner=st.hopper(template=...)`` gmem (K4) and shift (K2's ``RT_MAP``
   build), overlap on (400 launches: the deep interior and four strips a
   shard) and off (80), each field equal to 20 unsharded applications;
   (b) acoustic ISO at 512³ (PML 10, 100 steps, windows of 10, the source
   in ``between``) under K4 gmem at exchange depths 1 and 2: the launches
   ``HaloSpec`` implies, the fields within 2e-5 of their max of the
   unsharded gmem run, steps/s, collective bytes a window, the copy
   stream's exchange time and its overlap with the deep interior, the
   gather/scatter around each hook, the window's idle share
   (``torch.profiler``); (c) star3d4r ``batch=2`` at 256³, each scenario
   bit for bit its own sharded run; (d) the 256³ gradient (40 steps)
   through ``st.differentiable_timeloop(mesh=)`` against the unsharded
   adjoint; (e) ``run_resilient`` at 256³ with one failure, bit for bit;
   (f) ``predict(mesh=)`` with the probed link rate against (b)'s times
   and ``tune(mesh=)`` over the two depths.
15. the other language models — (a) each of mixtral-8x7b, mixtral-8x22b,
   granite-8b, gemma-7b, phi3-mini-3.8b, nemotron-4-15b, xlstm-1.3b,
   pixtral-12b and whisper-small at its published widths (f32 master
   weights, bf16 compute; depth cut where the f32 parameters would pass
   40 GB: ``LM_LAYERS``) serves 4 greedy requests of 8 new tokens through
   ``BatchServer`` (whisper: ``Generator.generate`` on 1500 frames):
   tokens/s, ms a decode step, peak GB; (b) the same parameters in f32,
   the decode steps' logits against the forward's on an 8-token prompt
   (1e-3 of the largest |logit|); (c) one representative a family
   (granite 2 layers, mixtral 1, pixtral 2, xlstm one cycle of 8 blocks,
   whisper whole) trains 3 AdamW steps of 1 x 4096 positions: ms a step,
   positions/s, peak GB, finite losses; (d) the same five at one layer,
   f32, TF32 off, 2 x 64 tokens: the loss (1e-5 relative) and every
   gradient leaf (1e-4 of its max) on the card against the CPU.  None of
   K1-K7 runs on these paths.
16. the LM side of the distributed layer — (a) recurrentgemma-9b at its
   published widths cut to phase 9's 3 layers, 2 x 4096 tokens, on a
   (2, 2) mesh of the card over (data, model): in f32 compute the sharded
   loss and gradients (``train_loop.make_sharded_loss_and_grad``) against
   the unsharded ones on the same parameters and batch (loss 1e-5
   relative, every gradient leaf 1e-4 of its max), one sharded AdamW step
   and every replica of a block equal to its primary; then 3 steps of
   the sharded step (``compile_train_step``) and of ``make_train_step``
   at the config's bf16 compute, ms a step and peak GB each, K6 launched
   3 x 2 recurrent layers x 2 model shards x 2 data groups a step and
   nothing else; one model shard's K6 input from that run,
   ``[1, 4099, 2048]`` bf16, bit for bit K6's plain version, timed beside
   it and ``F.conv1d``; (b) phi3-mini-3.8b whole (3.8 B parameters), 16 x
   512, on the production mesh (16, 16) of the card: in f32 compute the
   sharded loss and gradients against the unsharded ones (loss 1e-5
   relative, every gradient leaf 1e-4 of its max); then ``python -m
   repro_torch.launch.train --preset full --arch phi3-mini-3.8b
   --global-batch 16 --seq-len 512 --steps 1`` (in-process, bf16): its
   first loss within phase 9's bf16 1e-3 of the unsharded loss on the same
   parameters and batch (a forward pass, run first, then freed), seconds
   a step and peak GB; K1-K7 stay 0 there; (c) mixtral-8x7b (its
   published capacity, tokens dropped, the load-balancing loss against
   the unsharded one), pixtral-12b, xlstm-1.3b (f64) and whisper-small on
   (2, 2): the same f32 gates, then timed bf16 steps (MoE's statistics
   pass timed apart), K1-K7 staying 0; (d) ``--preset full`` whisper-small
   on (16, 16), its first loss against the unsharded one.
17. Sharded serving: one config a family on a (2, 2) mesh of the card
   and granite-8b whole on (16, 16) (its cache split by sequence), f32:
   the sharded prefill's logits and the greedy tokens of the sharded
   decode against the unsharded steps; every K6 launch of the sharded
   prefill and decode on a model shard's slice bit for bit its plain
   version, counted, and timed beside it and ``F.conv1d``.
18. the dry run's accounting — the sharded steps of 16 (a), 16 (b), 17 (a)
   (prefill and decode) and 17 (b), each run once on a mesh of meta
   shards of the same shape under ``op_analysis.Account``
   (``launch/dryrun.account_cell``; nothing runs on the card): FLOPs a
   step per device and executed, the achieved TFLOP/s (executed FLOPs
   over the phase's measured ms a step, against the card's peak for the
   compute dtype), bytes and collective bytes, the memory it predicts
   beside the measured peak.  Gates: a shard's argument bytes in the
   account equal those of the same state placed on the card (drawn and
   placed again here, summed over a shard's tensors), and its K6 ops
   equal the launches the card made (16 (a): 24 a step, 72 in all; 17
   (a)'s prefill: 8).
19. the examples — every script of ``examples/torch_port/`` through its
   ``main([...])`` on the card, as a user runs it: ``quickstart`` at its
   defaults (50 ``st.map`` steps of K4 gmem at 256² and 50 fused steps of
   K1, each against ``st.torch()``); ``acoustic_iso_3d`` at 512³, 100
   steps, on K4 gmem a step and on K2 in fused windows of 10, and
   ``--distributed`` at its defaults on ``st.torch()`` shards and on K4
   gmem shards; ``fwi``'s full inversion (48², 60 steps, 120 AdamW
   iterations) on K1, its final misfit below 10 % of the first, and
   ``--smoke --mesh 4``; ``serve_lm`` at its defaults (K6 in
   recurrentgemma's decode); ``train_lm --preset 100m --steps 150`` (16
   x 512, falling loss) and ``--preset smoke --ckpt-dir`` (a directory
   under ``build/smoke_tmp``, removed afterwards).  Each run's seconds
   and its K1/K2/K4/K6 launches (set to 0 just before it) beside the
   card's name and power limit; a path's kernel must launch, and no
   kernel off its path.

Every phase prints its wall seconds (``phase <n> <name>: <s> s``) and,
before the kernels line, a table of them, also in ``--json`` under
``phase_seconds``.  It prints the kernels line ``{"kernels": [...]}`` and then, last,
``{"ok": true, "device": {...}}``.  ``--quick`` runs phases 1–3 at the two
small shapes only (K6 and K7 at all of theirs, untimed) and prints no
result line.  Phases 4, 5 and 10 read the launch counts of the fused path, 6
and 7 those of ``st.map``, 8 those of serving, 9 those of training: each
sets the counts to 0 just before its run and reads them just after (11:
each batched run and the gradient; 12, 13 and 14: each run); the kernels line
gives K1/K2/K3/K5 their launches in phase 11's batched runs
(``batched_launches``), the tuned acoustic build's kernel and K6's
training entry theirs in phase 12's restarted runs (``resilient_launches``),
K4 gmem and K2's ``RT_MAP`` build theirs in phase 14's sharded runs and
K6 its launches in phase 16's sharded training steps (``sharded_launches``),
and lists K6 once a path (``causal_conv1d``: serving, at the decode shape;
``causal_conv1d.train``: training, at its shape; ``causal_conv1d.sharded``:
phase 16's sharded training, at one model shard's shape;
``causal_conv1d.sharded_prefill`` and ``causal_conv1d.sharded_decode``:
phase 17's sharded serving, at a model shard's prefill and decode
shapes).  Phase 15
sets the counts to 0 before its models and checks that they stay 0.  The script imports neither
JAX nor the JAX package, and needs nothing outside the checkout.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SMALL_SHAPES = ((64, 64, 64), (61, 70, 133))
MAIN_SHAPE = (512, 512, 512)
PML_SHAPE = (64, 64, 64)
STEPS = 100
ACOUSTIC_FUSE = 10
# kernel wrapper -> (template, time_block) of its main path
KERNELS = {"fused_step": ("gmem", 1), "stream_step": ("shift", 1),
           "temporal_step": ("shift", 2), "semi_step": ("semi", 1)}
REPLACES = {
    "fused_step": "src/repro/kernels/stencil/codegen.py:682",
    "stream_step": "src/repro/kernels/stencil/codegen.py:367",
    "temporal_step": "src/repro/kernels/stencil/codegen.py:699",
    "semi_step": "src/repro/kernels/stencil/codegen.py:319",
}
# per-application kernels of st.map: entry -> (kernel wrapper, template)
MAP_KERNELS = {"map_step.gmem": ("map_step", "gmem"),
               "map_step.f4": ("map_step", "f4"),
               "map_step.smem": ("map_step", "smem"),
               "stream_step.map": ("stream_step", "shift"),
               "semi_step.map": ("semi_step", "semi")}
REPLACES.update({
    "map_step.gmem": "src/repro/kernels/stencil/codegen.py:203",
    "map_step.f4": "src/repro/kernels/stencil/codegen.py:203",
    "map_step.smem": "src/repro/kernels/stencil/codegen.py:203",
    "stream_step.map": "src/repro/kernels/stencil/codegen.py:429",
    "semi_step.map": "src/repro/kernels/stencil/codegen.py:319",
})
# a sub-region of the ragged shape whose z-start (and origin) is not a
# multiple of 4: f4 loads from below its first cell
SUB_REGION = ((5, 50), (3, 61), (10, 127))
PML_WIDTH = 10
LISTING1_SHAPE, LISTING1_STEPS = (256, 256), 50
# K3 is also checked at an odd depth (the other leapfrog parity)
TEMPORAL_SMALL_DEPTHS = (2, 3)
# device memory rate (B/s) and f32 rate outside the tensor cores (FLOP/s)
# of the card the bounds were derived for, from NVIDIA's data sheet (H100
# SXM); another card gets no bound
CARD_RATES = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
# K6 and K7: the TPU kernels they replace, their shapes in phase 3, the
# served model of phase 8 and the trained one of phase 9
REPLACES.update({
    "causal_conv1d": "src/repro/kernels/conv1d/conv1d.py:50",
    "decode_attention": "src/repro/kernels/decode_attn/decode_attn.py:84",
})
SERVE_ARCH = "recurrentgemma-9b"
SERVE_REQUESTS, SERVE_BATCH, SERVE_MAX_NEW = 8, 4, 8
SERVE_PROMPT_LEN = (4, 16)
SERVE_CHECK_STEPS = 4
# the training path (phase 9): recurrentgemma-9b at its published widths,
# depth cut to one (rec, rec, attn) cycle, batch 2, train_4k's sequence
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH, TRAIN_SEQ = "recurrentgemma-9b", 3, 2, 4096
TRAIN_STEPS = 4
# the first step's loss with K6 against it with K6's plain version
# (relative), and conv_w's gradient (of its max magnitude: the JAX
# package's bf16 tolerance, the cotangents being bf16)
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_TOL = 3e-2
# K6 at decode (T = cw = 4 rows: the conv state and the new token), at a
# prefill-sized shape, at the training path's (the sequence and its cw - 1
# rows of zero history) and at a ragged shape; decode and training are
# the main paths'
CONV_SHAPES = {"decode": (SERVE_BATCH, 4, 4096), "prefill": (4, 2048, 4096),
               "train": (TRAIN_BATCH, TRAIN_SEQ + 3, 4096),
               "ragged": (3, 1001, 4100)}
CONV_WIDTHS = (1, 4)
# K7: (B, H, K, hd, S) at RecurrentGemma's decode shape and a GQA one
ATTN_SHAPES = {"recurrentgemma": (8, 16, 1, 256, 2048),
               "recurrentgemma B=1": (1, 16, 1, 256, 2048),
               "gqa": (4, 8, 2, 128, 1000)}
ATTN_TIMED = ("recurrentgemma", "recurrentgemma B=1")
# kernel vs plain version: K6 rounds as its plain version does (bit for
# bit expected; f32 1e-6, bf16 one rounding 8e-3, of max(1, |plain|)); K7
# sums in another order (bf16 output: 1e-2; its f32 partials and combine:
# 2e-5)
CONV_TOL = {"float32": 1e-6, "bfloat16": 8e-3}
ATTN_TOL = 1e-2
ATTN_PART_TOL = 2e-5
# served logits with K6 vs with its plain version (same roundings: equal
# expected; 2e-2 of max(1, |logits|) for bf16 roundings that propagate),
# and K7 vs ``_sdpa`` in bf16 (which rounds its logits and probabilities
# to bf16): the JAX package's bf16 tolerance, 3e-2
SERVE_LOGITS_TOL = 2e-2
SDPA_TOL = 3e-2
# hopper vs st.torch() after 100 steps, relative to the field's max: the
# leapfrog update carries per-step rounding differences (FMA contraction,
# summation order) forward; an H100 reads 4e-7 (star) and 2e-6 (acoustic)
END_TO_END_RTOL = 2e-5
# bf16 kernels vs their plain versions: both compute in f32 and round once,
# so an output cell may differ by one rounding, one bf16 ulp of the
# magnitude
BF16_TIMED = ("fused_step", "stream_step", "temporal_step")
# per-application kernels held against their plain versions in bf16 at
# every shape and the sub-region, and timed at 512³ (the others: bf16 at
# the small shapes)
MAP_BF16_ALL = ("gmem", "f4", "smem", "shift")
# K2's two staging forks timed side by side at 512³ (TMA, granules,
# granules, TMA, ...): rounds, and launches timed per turn after warm-up
FORK_ROUNDS, FORK_REPS = 3, 30
# conv3d in bf16 vs the plain version on bf16 grids: its weights (the
# star's coefficients) are rounded to bf16, each to 2^-9 of itself, and its
# output once; the JAX package's bf16 tolerance, 3e-2 of the magnitude
LIBRARY_BF16_TOL = 3e-2
# phase 10: the tune's steps and shortlist (st.launch's defaults), the
# bound on the two-stage winner's measured time over the exhaustive
# winner's, and the tune cache (emptied first: the first tune is cold)
AUTOTUNE_STEPS, AUTOTUNE_TOP_K = 16, 3
AUTOTUNE_RATIO = 1.15
AUTOTUNE_CACHE = ROOT / "build" / "autotune_cache"
# phase 11: batched shots (one source and model a shot; the blob sits
# BLOB_OFFSET cells beside the source along axis 2, which the wave reaches
# within the 100 steps), star3d4r's scenarios, and the gradient: its
# default schedule (fuse = ceil(sqrt(100)) = 10, 10 checkpoints), its
# tolerance against the torch adjoint (of each gradient's max: the two
# forward passes differ by f32 rounding) and the central difference along
# the blob (relative)
BATCH_SHOTS, STAR_SHOTS = 4, 2
BATCH_SOURCES = ((256, 256, 176), (256, 256, 224), (256, 256, 272), (256, 256, 320))
BLOB_OFFSET, BLOB_RADIUS, BLOB_DVP2 = 12, 8, 0.56
ADJOINT_FUSE = 10
ADJOINT_TOL = 1e-3
ADJOINT_EPS = 0.01
ADJOINT_FD_TOL = 2e-2
# the kernel wrapper that runs each plan kind
# phase 12: resilience.  (a) at MAIN_SHAPE, failures before windows 3 and
# 7 of 20, a save every 5; (b) the gradient at GRAD_SHAPE: 10 windows, the
# seed, 10 backward segments = 21 units, a save every 6 (4 saves), failures
# before a forward unit and a backward one; (c) the CLI's smoke training
# (its defaults: lr, warmup, seq, batch), a failure before step 3 of 6
RESILIENCE_FAILS = (3, 7)
RESILIENCE_CKPT_EVERY = 5
GRAD_SHAPE = (256, 256, 256)
GRAD_CKPT_EVERY = 6
GRAD_FAILS = (4, 15)
TRAIN_RESTART_STEPS = 6
TRAIN_RESTART_EVERY = 2
TRAIN_RESTART_FAIL = 3
TRAIN_CLI_SEQ, TRAIN_CLI_BATCH, TRAIN_CLI_LR, TRAIN_CLI_WARMUP = 128, 8, 3e-4, 10
CKPT_ROOT = ROOT / "build" / "smoke_tmp"
# phase 13: stencil serving, the JAX test's tolerance against serial runs
SIM_REQUESTS = 16
SIM_SEED = 13
SIM_SHAPE_RANGE = (129, 256)
SIM_STEP_RANGE = (20, 100)
SIM_ZERO = 5
SIM_CAP = 8
SIM_FUSE = 10
SIM_RTOL, SIM_ATOL = 1e-5, 1e-6
KIND_WRAPPER = {"fused": "fused_step", "stream": "stream_step",
                "semi": "semi_step", "temporal": "temporal_step"}
# phase 14: the distributed layer on one card, a (2, 2) mesh over (data,
# model) splitting axes 0 and 1; (a) st.map applications at MAIN_SHAPE,
# (b) the fused window at the exchange depths, (c)-(e) at DIST_SHAPE: the
# batch, the gradient's steps, the failure before window DIST_FAIL; (f)
# the tune's steps.  Fields of the sharded runs against the unsharded ones
# (of the field's max: the same kernels on the same regions, 0 expected),
# gradients (of each gradient's max)
DIST_MESH = (2, 2)
DIST_AXES = ("data", "model", None)
DIST_APPS = 20
DIST_DEPTHS = (1, 2)
DIST_SHAPE = (256, 256, 256)
DIST_BATCH, DIST_BATCH_STEPS = 2, 20
DIST_GRAD_STEPS = 40
DIST_FAIL = 2
DIST_TUNE_STEPS = 20
DIST_TOL = 2e-5
DIST_GRAD_TOL = 1e-4
# phase 15: the nine other language models at their published widths, f32
# master weights, compute in each config's dtype (bf16).  Depth: the
# config's own where its f32 parameters fit in LM_PARAM_GB (by
# api.param_count), else the largest that does, so that a model and its
# decode temporaries fit the card beside nothing else:
#   mixtral-8x7b   6 of 32 layers, 8.97 B params, 35.9 GB
#   mixtral-8x22b  3 of 56 layers, 7.91 B params, 31.7 GB
#   nemotron-4-15b 17 of 32 layers, 9.78 B params, 39.1 GB
#   pixtral-12b    31 of 40 layers, 9.79 B params, 39.2 GB
# granite-8b (33.0 GB), gemma-7b (34.2), phi3-mini (15.3), xlstm-1.3b (4.4)
# and whisper-small (1.0) run whole.
LM_ARCHS = ("mixtral-8x7b", "mixtral-8x22b", "granite-8b", "gemma-7b",
            "phi3-mini-3.8b", "nemotron-4-15b", "xlstm-1.3b", "pixtral-12b",
            "whisper-small")
LM_PARAM_GB = 40.0
LM_LAYERS = {"mixtral-8x7b": 6, "mixtral-8x22b": 3, "nemotron-4-15b": 17,
             "pixtral-12b": 31}
# (a) serving: BatchServer waves of 4 greedy requests (whisper:
# Generator.generate with 1500 frames, one prompt length)
# (LM_PROMPT_LEN cut (4, 16) -> (4, 8) for phase 19's room: a wave's context
# buckets to 16 positions, not 32)
LM_REQUESTS, LM_MAX_NEW, LM_PROMPT_LEN, LM_FRAMES = 4, 8, (4, 8), 1500
# (b) decode against forward in f32 on a prompt of LM_CHECK_LEN tokens, 2
# rows: within LM_CHECK_TOL of the largest |logit|; moe with capacity
# factor n_experts (dropless in both groupings, as configs.tiny does)
LM_CHECK_LEN, LM_CHECK_TOL = 8, 1e-3
# (c) 3 steps of make_train_step, batch 1 x train_4k's 4096 positions, one
# representative a family, depth cut so that the training state (f32
# params, AdamW moments and gradients: 16 B a parameter) stays near 30 GB
# or under: granite 2 layers 13.4 GB, mixtral 1 layer (capacity 1.25)
# 27.4 GB, pixtral 2 layers (1024 prefix embeddings) 30.2 GB, xlstm one
# cycle of 8 blocks (7 mLSTM, 1 sLSTM) 4.3 GB, whisper whole 3.8 GB
LM_TRAIN = {"granite-8b": {"n_layers": 2}, "mixtral-8x7b": {"n_layers": 1},
            "pixtral-12b": {"n_layers": 2}, "xlstm-1.3b": {"n_layers": 8},
            "whisper-small": {}}
LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = 3, 1, 4096
# (d) the same five at one layer (xlstm one cycle, whisper 1 + 1), f32,
# 2 rows of 64 tokens (vlm: 16 patch embeddings before them; audio: 64
# frames), loss and every gradient on the card against the CPU, TF32 off:
# the loss within 1e-5 relative, a gradient leaf within 1e-4 of its max.
# A leaf that f32 rounding alone moves further is held to the CPU in f64
# instead, within LM_CPU_F64_TOL: the stacked mLSTM normalizers amplify
# rounding, and this phase reads one xlstm cycle's f32 gradients 3.2e-3
# of a leaf's max apart, the CPU's own f32 1.2e-3 from f64, and the two
# f64 runs within 2.9e-12 (NVIDIA H100 80GB HBM3, 700 W)
LM_CPU = {"granite-8b": {"n_layers": 1}, "mixtral-8x7b": {"n_layers": 1},
          "pixtral-12b": {"n_layers": 1, "n_prefix_tokens": 16},
          "xlstm-1.3b": {"n_layers": 8},
          "whisper-small": {"n_layers": 2, "n_enc_layers": 1, "n_dec_layers": 1}}
LM_CPU_BATCH, LM_CPU_TOKENS = 2, 64
LM_CPU_LOSS_RTOL, LM_CPU_GRAD_TOL, LM_CPU_F64_TOL = 1e-5, 1e-4, 1e-9
# phase 16: the LM side of the distributed layer.  (a) phase 9's model and
# batch (TRAIN_ARCH, TRAIN_LAYERS, TRAIN_BATCH x TRAIN_SEQ) on a (2, 2)
# mesh of the card over (data, model): f32 gates against the unsharded
# loss and gradients (phase 9's: loss 1e-5 relative, a gradient leaf 1e-4
# of its max), then SHARD_STEPS timed bf16 steps each way; K6 on one model
# shard's slice bit for bit its plain version.  (b) FULL_ARCH whole,
# FULL_BATCH x FULL_SEQ, on the production mesh (16, 16) of the card: in
# f32 compute the sharded loss and gradients against the unsharded ones
# (the same gates as (a)); then the CLI's --preset full, FULL_STEPS steps
# at the config's bf16, its first loss within TRAIN_LOSS_RTOL (phase 9's
# bf16 tolerance) of the unsharded bf16 step's.  In bf16 the two differ
# by rounding alone, but a 16-bit activation that one f32 ulp of another
# summation order rounds the other way moves a 32-layer loss ~1e-5: the
# first losses read 9.1e-6 apart with the partial products in f32 and
# 1.4e-5 with them as 16-bit products accumulated in f32 (my chip runs,
# NVIDIA H100 80GB HBM3, 700 W), so a 1e-5 gate holds in f32 only
SHARD_MESH = (2, 2)
SHARD_STEPS = 3
SHARD_LOSS_RTOL, SHARD_GRAD_TOL = 1e-5, 1e-4
# (FULL_STEPS cut 2 -> 1 for phase 19's room: 16-22 s a step)
FULL_ARCH, FULL_BATCH, FULL_SEQ, FULL_STEPS = "phi3-mini-3.8b", 16, 512, 1
# (c) the four families PR 24 added, on SHARD_MESH: the gates of (a) at
# phase 15 (d)'s depths (LM_CPU) and batch, xLSTM in f64 (its f32
# gradients are ill-conditioned), mixtral at MOE_GATE_BATCH x
# MOE_GATE_SEQ tokens with its published capacity 1.25 (each data group
# one whole routing group of 4096 tokens, capacity 1280 of 8192 slots:
# tokens dropped), its load-balancing loss within SHARD_AUX_RTOL of the
# unsharded one; then FAMILY_STEPS timed bf16 steps at phase 15 (c)'s
# depths (LM_TRAIN), FAMILY_BATCH x LM_TRAIN_SEQ.  (d) the CLI's --preset
# full for AUDIO_FULL_ARCH whole on the production mesh (16, 16), its
# heads (12) and vocab (51865) replicated over the 16 model shards:
# AUDIO_FULL_STEPS steps, the first loss within TRAIN_LOSS_RTOL of the
# unsharded bf16 loss
FAMILY_ARCHS = ("mixtral-8x7b", "pixtral-12b", "xlstm-1.3b", "whisper-small")
MOE_GATE_BATCH, MOE_GATE_SEQ, SHARD_AUX_RTOL = 2, 4096, 1e-6
FAMILY_BATCH = 2
AUDIO_FULL_ARCH, AUDIO_FULL_BATCH, AUDIO_FULL_SEQ, AUDIO_FULL_STEPS = (
    "whisper-small", 16, 1024, 1)
# cut for phase 19's room: (c)'s timed steps 3 -> 2 (xLSTM's sharded step
# takes 5.1 s), (d)'s CLI steps 2 -> 1 (12.4 s a step); the gates unchanged
FAMILY_STEPS = 2
# phase 17: sharded serving.  (a) one config a family on SERVE_MESH at
# phase 15's depths (recurrentgemma-9b at phase 9's), f32: the sharded
# prefill's logits within SERVE17_TOL of the largest |logit| of the
# unsharded prefill, SERVE17_NEW greedy tokens a row after a prompt of
# SERVE17_PROMPT, token for token the unsharded decode's; every K6 launch
# of the sharded prefill (one a model shard, data group and recurrent
# layer) and of the sharded decode (as many again a step) bit for bit its
# plain version, and counted.  (b) GRANITE17_ARCH whole on the
# production mesh, GRANITE17_BATCH rows (one a data group), cache
# GRANITE17_CACHE: its 8 KV heads do not split 16 ways, so the cache
# splits by sequence (kv_mode "seq"); the same gates.  (b)'s prompt enters
# the cache through the port's unsharded transformer.prefill (a sharded
# decode step of the 256 shards takes seconds, host-bound), then
# GRANITE17_NEW sharded decode steps.  Cut for phase 19's room: (a)'s
# prompt 16 -> 8 tokens and new tokens 8 -> 2 (23 -> 9 decode steps), its
# depths phi3-mini 32 -> 8 layers, pixtral 31 -> 8, xLSTM 48 -> 16 (two
# cycles); (b)'s decode steps 8 -> 2 (4.2-4.7 s each on (16, 16))
SERVE17 = {"phi3-mini-3.8b": {"n_layers": 8}, "mixtral-8x7b": {"n_layers": 6},
           "pixtral-12b": {"n_layers": 8}, "xlstm-1.3b": {"n_layers": 16},
           "whisper-small": {}, "recurrentgemma-9b": {"n_layers": 3}}
SERVE_MESH = (2, 2)
SERVE17_BATCH, SERVE17_PROMPT, SERVE17_NEW, SERVE17_TOL = 2, 8, 2, 1e-3
# the prefill's prompt where it differs from SERVE17_PROMPT: a MoE prefill
# routes groups of min(group_size, the batch's tokens), and mixtral's 4096
# is one row only at a prompt of 4096 (shorter, a routing group would
# straddle the data groups at capacity 1.25, which the port refuses)
SERVE17_PREFILL = {"mixtral-8x7b": 4096}
GRANITE17_ARCH, GRANITE17_BATCH, GRANITE17_CACHE = "granite-8b", 16, 4096
GRANITE17_NEW = 2
# phase 18: the card's peak FLOP rate for a compute dtype (the data
# sheet's dense rates: bf16 on the tensor cores, f32 outside them)
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12}}


def bf16_ulp(scale: float) -> float:
    """One bf16 ulp (8 significant bits) at ``scale`` (>= 1)."""
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def max_diff(torch, key, got, ref):
    """(max |got - ref| over the grids of ``ref``, max |ref|); fails on a
    non-finite field of ``got`` or a difference over the limit."""
    diff = 0.0
    for g, ref_g in ref.items():
        a = got[g].data
        if not bool(torch.isfinite(a).all()):
            fail(f"{key}: non-finite field '{g}' after {STEPS} steps")
        diff = max(diff, float((a - ref_g.data).abs().max()))
    scale = max(float(r.data.abs().max()) for r in ref.values())
    if diff > END_TO_END_RTOL * max(scale, 1e-3):
        fail(f"{key}: max |hopper - torch| = {diff} after {STEPS} steps "
             f"(field max {scale}, limit {END_TO_END_RTOL} of it)")
    return diff, scale


def star_conv(torch, w, codegen, plain, ref):
    """``star3d4r`` as one library call: ``conv3d`` (a correlation, as
    ``u.at`` reads) of the halo'd ``u`` with the star's taps as a dense
    (2h+1)³ weight, zero off the star, in the grids' type (f32 with TF32
    off, or bf16).  The weight is the plain version's response to a unit
    impulse, flipped (rounded to bf16 for bf16 grids).  Checked against the
    plain version's output in ``ref`` (f32: 2e-5 of the magnitude; bf16:
    ``LIBRARY_BF16_TOL``); returns (ms, max abs err)."""
    F = torch.nn.functional
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    h = w.halo
    n = 2 * h + 1
    probe = w.plan(codegen, (n,) * 3, "gmem")
    imp = {g: torch.zeros((n + 2 * h,) * 3, device="cuda")
           for g in w.kernel.ir.grid_params}
    imp["u"][(2 * h,) * 3] = 1.0
    imp = probe.to_padded(imp)
    plain(probe, imp, {})
    x = ref["u"][None, None]
    weight = (imp["v"][h:-h, h:-h, h:-h].flip(0, 1, 2).contiguous()[None, None]
              .to(x.dtype))
    out = F.conv3d(x, weight)[0, 0]
    want = ref["v"][h:-h, h:-h, h:-h]
    err = float((out.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    tol = 2e-5 if x.dtype == torch.float32 else LIBRARY_BF16_TOL
    if err > tol * scale:
        fail(f"conv3d[star3d4r] {x.dtype}: max |conv3d - plain| = {err} > "
             f"{tol} * {scale}")
    del out
    return time_ms(torch, lambda: F.conv3d(x, weight), 5, 2), err


class Workload:
    """One main-path kernel (or ``kernel``, given): its IR, halos, fields
    made from a seed."""

    def __init__(self, name, mods, kernel=None):
        self.name = name
        st, suite, acoustic = mods["st"], mods["suite"], mods["acoustic"]
        if kernel is not None:
            self.kernel, self.swap, self.scalars = kernel, None, {}
        elif name == "star3d4r":
            self.kernel = suite.get_kernel("star3d4r")
            self.swap = ("v", "u")
            self.scalars = {}
        else:
            self.kernel = acoustic.acoustic_iso_kernel
            self.swap = ("p0", "p1")
            self.scalars = {"dt": 0.30000001192092896}      # f32(0.3)
        self.st = st
        self.halo = self.kernel.info.order

    def plan(self, codegen, shape, template, time_block=1):
        halos = {g: (self.halo,) * 3 for g in self.kernel.ir.grid_params}
        return codegen.plan_cuda(
            self.kernel.ir, halos, shape,
            self.st.hopper(template=template, time_block=time_block),
            swap=self.swap)

    def map_plan(self, codegen, shape, template, region=None):
        halos = {g: (self.halo,) * 3 for g in self.kernel.ir.grid_params}
        return codegen.lower_hopper(self.kernel.ir, halos, shape, region,
                                    self.st.hopper(template=template))

    def arrays(self, torch, shape, seed, dtype=None):
        """Random halo'd fields on the card (torch generator, seeded;
        rounded to ``dtype`` when given); acoustic coefficients in their
        physical ranges."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        full = tuple(s + 2 * self.halo for s in shape)
        out = {}
        for g in self.kernel.ir.grid_params:
            if g == "vp2":
                out[g] = 0.5 + 1.5 * torch.rand(full, generator=gen, device="cuda")
            elif g == "damp":
                out[g] = 0.2 * torch.rand(full, generator=gen, device="cuda")
            else:
                out[g] = torch.randn(full, generator=gen, device="cuda")
        return out if dtype is None else {g: t.to(dtype) for g, t in out.items()}


def extra_kernels(st):
    """A Jacobi sweep that reads its output grid off-center (its
    per-application kernels write into a destination buffer), and the
    paper's Listing 1 stencil (``examples/quickstart.py``)."""
    @st.kernel
    def jacobi3d(u: st.grid, f: st.grid):
        u.at(0, 0, 0).set(0.16666667 * (u.at(-1, 0, 0) + u.at(1, 0, 0)
                                        + u.at(0, -1, 0) + u.at(0, 1, 0)
                                        + u.at(0, 0, -1) + u.at(0, 0, 1))
                          - 0.5 * f.at(0, 0, 0))

    @st.kernel
    def kernel_star2d4r(u: st.grid, v: st.grid):
        v.at(0, 0).set(0.25005 * u.at(0, 0)
                       + 0.11111 * (u.at(-4, 0) + u.at(4, 0))
                       + 0.06251 * (u.at(-3, 0) + u.at(3, 0))
                       + 0.06255 * (u.at(-2, 0) + u.at(2, 0))
                       + 0.06245 * (u.at(-1, 0) + u.at(1, 0))
                       + 0.06248 * (u.at(0, -1) + u.at(0, 1))
                       + 0.06243 * (u.at(0, -2) + u.at(0, 2))
                       + 0.06253 * (u.at(0, -3) + u.at(0, 3))
                       - 0.22220 * (u.at(0, -4) + u.at(0, 4)))
    return jacobi3d, kernel_star2d4r


def map_cases(w, jacobi, shapes):
    """(shape, region) of every per-application case of workload ``w`` in
    phase 3: the workloads at each shape and the sub-region of the ragged
    one, the Jacobi kernel at the ragged shape and the sub-region."""
    if w is jacobi:
        return [(SMALL_SHAPES[1], None), (SMALL_SHAPES[1], SUB_REGION)]
    return [(shape, None) for shape in shapes] + [(SMALL_SHAPES[1], SUB_REGION)]


def map_dtypes(torch, template, shape, region):
    """Grid types a per-application case runs in: f32 everywhere, bf16 at
    the small shapes, and for gmem, f4, smem and shift (``MAP_BF16_ALL``)
    at 512³ and the sub-region too."""
    if template in MAP_BF16_ALL or (shape in SMALL_SHAPES and region is None):
        return (torch.float32, torch.bfloat16)
    return (torch.float32,)


def path_of(plan, dtype):
    """The path of a K1 or K4 gmem build (its points a lane and each read
    grid's pair or single-cell loads), the load path of an f4 build
    (per grid: aligned at plan time, or at run time) or the staging path
    of an smem, K2 or K3 build (TMA or 4-byte granules; K2/K3 with the TMA
    box's lead)."""
    if plan.kind == "fused" or (plan.kind == "map" and plan.template == "gmem"):
        cells = plan.gmem_column().cells
        pairs = {g: v for g, v in plan.gmem_pairs(dtype).items() if g in plan.in_grids}
        return {"path": f"gmem, {cells} points a lane, " + ", ".join(
            f"{g}: {'pairs' if v else 'cells'}" for g, v in pairs.items()),
            "gmem_pairs": pairs, "points_a_lane": cells}
    if plan.kind in ("stream", "temporal"):
        lay = plan.ring_layout(dtype)
        rings = ({plan.swap[1]: lay.planes[-1]} if plan.kind == "temporal"
                 else lay.planes)
        return {"path": f"{plan.kind} " + ", ".join(
            f"{g}: {f'TMA (lead {pl.lead})' if pl.tma else 'cp.async granules'}"
            for g, pl in rings.items()),
            "stream_tma": {g: pl.tma for g, pl in rings.items()},
            "smem_bytes": lay.smem}
    if plan.template == "f4":
        org = plan.f4_org_mod4()
        return {"path": "f4 " + ", ".join(
            f"{g}: {'run-time alignment' if o is None else f'aligned (place {o})'}"
            for g, o in org.items()), "f4_org_mod4": org}
    tma = plan.smem_tma(dtype)
    return {"path": "smem " + ", ".join(
        f"{g}: {'TMA' if v else 'cp.async granules'}" for g, v in tma.items()),
        "smem_tma": tma}


def fused_depths(kname, shape):
    """The depths phase 3 runs a fused kernel at: K3 at k=2 and k=3 at the
    small shapes and k=2 at 512³, the others one step."""
    if kname != "temporal_step":
        return (KERNELS[kname][1],)
    return TEMPORAL_SMALL_DEPTHS if shape in SMALL_SHAPES else (KERNELS[kname][1],)


def granule_plan(plan):
    """``plan`` with K2's staging forced to 4-byte granules (the TMA path's
    alternative), before its first source."""
    plan.allow_tma = False
    return plan


def stream_forks(torch, codegen, stream_step, forks):
    """K2's two staging paths side by side at 512³ for each (workload,
    dtype) of ``forks``: the plan's TMA build and the same kernel on 4-byte
    granules, checked against each other after one launch (f32: 2e-5 of
    the magnitude; bf16: one ulp), then timed in turns (TMA, granules,
    granules, TMA; ``FORK_ROUNDS`` rounds of ``FORK_REPS`` launches).
    Returns the rows."""
    rows = []
    for w, dtype in forks:
        plans = {"tma": w.plan(codegen, MAIN_SHAPE, "shift"),
                 "granules": granule_plan(w.plan(codegen, MAIN_SHAPE, "shift"))}
        name = str(dtype).split(".")[1]
        key = f"stream_step[{w.name}] {name} forks"
        for fork, plan in plans.items():
            if set(plan.stream_tma(dtype).values()) != {fork == "tma"}:
                fail(f"{key}: the {fork} build stages {plan.stream_tma(dtype)}")
        arrays = w.arrays(torch, MAIN_SHAPE, seed=12, dtype=dtype)
        runs, outs = {}, {}
        for fork, plan in plans.items():
            padded = plan.to_padded({g: t.clone() for g, t in arrays.items()})
            stream_step(plan, padded, w.scalars)
            outs[fork] = {g: padded[g].clone() for g in plan.out_grids}
            runs[fork] = (lambda plan=plan, padded=padded:
                          stream_step(plan, padded, w.scalars))
        torch.cuda.synchronize()
        err = check_out(torch, f"{key}: granules vs TMA", outs["granules"],
                        outs["tma"], bf16_ulp if dtype == torch.bfloat16 else rel_tol)
        ms = {fork: [] for fork in runs}
        for _ in range(FORK_ROUNDS):
            for fork in ("tma", "granules", "granules", "tma"):
                ms[fork].append(time_ms(torch, runs[fork], FORK_REPS, 5))
        row = {"kernel": f"stream_step[{w.name}]", "dtype": name,
               "max_abs_diff": err, **{f"{f}_ms": v for f, v in ms.items()}}
        rows.append(row)
        med = {f: sorted(v)[len(v) // 2] for f, v in ms.items()}
        say(f"fork {key}: TMA {med['tma']:.4f} ms (min {min(ms['tma']):.4f}, max "
            f"{max(ms['tma']):.4f}), granules {med['granules']:.4f} ms (min "
            f"{min(ms['granules']):.4f}, max {max(ms['granules']):.4f}); |diff| "
            f"{err:.3g}")
        del arrays, runs, outs
        torch.cuda.empty_cache()
    return rows


def ptxas_usage(log: str, kernel: str = "map_step_kernel"):
    """Registers and spill bytes of ``kernel`` in an ``nvcc -Xptxas -v``
    log (None where the log does not say)."""
    out = {"registers": None, "spill_stores": None, "spill_loads": None}
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            for nxt in lines[i + 1:i + 6]:
                m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt)
                if m:
                    out["spill_stores"], out["spill_loads"] = map(int, m.groups())
                m = re.search(r"Used (\d+) registers", nxt)
                if m:
                    out["registers"] = int(m.group(1))
            break
    return out


def bound_of(rates, nbytes: float, nflop: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the f32 rate; (None, None)
    without rates."""
    if rates is None:
        return None, None
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = nflop / rates[1] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def rel_tol(scale: float) -> float:
    """f32 kernel vs plain version: sums of the taps in another order,
    with FMA contraction on the card, a few ulp of the magnitude."""
    return 2e-5 * scale


def check_out(torch, key, got, want, tol):
    """max |got - want| over the grids of ``want``; fails on a non-finite
    output or a difference over ``tol(max(1, |want|))``."""
    err = 0.0
    for g, b in want.items():
        a = got[g]
        if not bool(torch.isfinite(a).all()):
            fail(f"{key}: non-finite output '{g}'")
        e = float((a.float() - b.float()).abs().max())
        scale = max(1.0, float(b.float().abs().max()))
        if e > tol(scale):
            fail(f"{key}: max |kernel - plain| = {e} > {tol(scale)} "
                 f"(magnitude {scale})")
        err = max(err, e)
    return err


def one_map(torch, key, kern, plain, plan, arrays, scalars, tol=rel_tol):
    """One application of per-application kernel ``kern`` and of its plain
    version on copies of the same grids; returns (max abs err, timing
    closures).  Fails on a non-finite output, a difference over
    ``tol(max(1, |plain|))`` or, when the plan writes to destinations, a
    write into a grid."""
    bufs = {g: arrays[g] for g in plan.opnd_grids}
    ref = {g: t.clone() for g, t in bufs.items()}
    dst, rdst = plan.make_dst(bufs), plan.make_dst(ref)
    kern(plan, bufs, scalars, dst)
    plain(plan, ref, scalars, rdst)
    torch.cuda.synchronize()
    # in place the whole tensor: cells outside the region must keep their
    # values, as the plain version leaves them
    got, want = (bufs, ref) if dst is None else (dst, rdst)
    err = check_out(torch, key, {g: got[g] for g in plan.out_grids},
                    {g: want[g] for g in plan.out_grids}, tol)
    if dst is not None and not all(torch.equal(bufs[g], ref[g]) for g in bufs):
        fail(f"{key}: the kernel wrote a grid it should leave to the copy")
    return (err, lambda: kern(plan, bufs, scalars, dst),
            lambda: plain(plan, ref, scalars, rdst))


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, calls: int = 100, replays: int = 20) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in one
    CUDA graph, its replays timed with CUDA events, so the host's launch
    overhead (which bounds back-to-back eager calls of a small kernel) is
    out of the count."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = time_ms(torch, graph.replay, replays, 2) / calls
    del graph
    return ms


def one_launch(torch, kname, kern, plain, plan, arrays, scalars):
    """One launch of kernel ``kern`` and of its plain version on the same
    layout buffers; returns (kernel result, plain result, timing closures),
    the results keyed by the grids they write.  K3 writes into spares and
    must leave the buffers it reads as they were."""
    padded = plan.to_padded(arrays)
    if kname == "temporal_step":
        before = {g: t.clone() for g, t in padded.items()}
        spares, ref = plan.make_spares(padded), plan.make_spares(padded)
        kern(plan, padded, spares, scalars)
        plain(plan, padded, ref, scalars)
        torch.cuda.synchronize()
        for g, t in padded.items():
            if not bool(torch.equal(t, before[g])):
                fail(f"{kname}: the kernel wrote the buffer of '{g}' it reads")
        del before
        return (spares, ref,
                lambda: kern(plan, padded, spares, scalars),
                lambda: plain(plan, padded, ref, scalars))
    ref = {g: t.clone() for g, t in padded.items()}
    kern(plan, padded, scalars)
    plain(plan, ref, scalars)
    torch.cuda.synchronize()
    return (padded, ref, lambda: kern(plan, padded, scalars),
            lambda: plain(plan, ref, scalars))


def conv_entry_of(name, row, path):
    """A kernels-line entry of K6 from a timed row of ``conv_phase``."""
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/conv1d/csrc/conv1d.cu",
            "replaces": REPLACES["causal_conv1d"], "launches": None,
            "max_abs_err": None, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "path": path,
            "shape": row["shape"], "dtype": row["dtype"], "build": row["build"]}


def conv_phase(torch, rates, conv, conv_ref, quick: bool):
    """K6 against its plain version on the card: bf16 and f32 at each of
    ``CONV_SHAPES`` and ``CONV_WIDTHS``, every build that takes the
    tensors (the vector build where ``build_of`` picks it, the lane build
    everywhere), one launch each; times (CUDA graphs) of the build
    ``build_of`` picks, the plain version and ``F.conv1d`` at every shape
    with width 4 in bf16, and in f32 at the prefill and training shapes.
    Returns (kernel-line entries of the serving and training paths, rows,
    worst difference)."""
    F = torch.nn.functional
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst, rows, timed = 0.0, [], {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[1]
        for label, (B, T, W) in CONV_SHAPES.items():
            for cw in CONV_WIDTHS:
                x = torch.randn((B, T, W), generator=gen, device="cuda").to(dtype)
                w = (0.3 * torch.randn((cw, W), generator=gen,
                                       device="cuda")).to(dtype)
                want = conv_ref.causal_conv1d_ref(x, w)
                chosen = conv.build_of(x, w, want)
                for build in dict.fromkeys((chosen, "lane")):
                    key = (f"causal_conv1d {dname} {label} [{B}, {T}, {W}] "
                           f"cw={cw} {build}")
                    got = conv.causal_conv1d_cuda(x, w, build=build)
                    torch.cuda.synchronize()
                    if got.dtype != dtype or got.shape != x.shape \
                            or not bool(torch.isfinite(got).all()):
                        fail(f"{key}: output {got.dtype} {tuple(got.shape)}, "
                             f"finite {bool(torch.isfinite(got).all())}")
                    err = float((got.float() - want.float()).abs().max())
                    scale = max(1.0, float(want.float().abs().max()))
                    if err > CONV_TOL[dname] * scale:
                        fail(f"{key}: max |kernel - plain| = {err} > "
                             f"{CONV_TOL[dname]} * {scale}")
                    worst = max(worst, err)
                    row = {"case": key, "shape": [B, T, W], "dtype": dname,
                           "cw": cw, "build": build, "max_abs_err": err,
                           "bit_equal": bool(torch.equal(got, want))}
                    say(f"kernel {key}: max abs err {err:.3g}"
                        f"{' (bit for bit)' if row['bit_equal'] else ''}")
                    timed_case = cw == 4 and build == chosen and not quick and (
                        dtype == torch.bfloat16 or label in ("prefill", "train"))
                    if timed_case:
                        row.update(conv_times(torch, F, rates, conv, conv_ref,
                                              x, w, want, label, key))
                        timed[(label, dname)] = row
                    rows.append(row)
                    del got
                del x, w, want
    entries = []
    if not quick:
        for path, label in (("serving", "decode"), ("training", "train")):
            name = "causal_conv1d" + ("" if path == "serving" else ".train")
            entries.append(conv_entry_of(name, timed[(label, "bfloat16")], path))
    torch.cuda.empty_cache()
    return entries, rows, worst


def conv_times(torch, F, rates, conv, conv_ref, x, w, want, label, key):
    """Device times (CUDA graphs) of K6's build, its plain version and
    ``F.conv1d`` on ``x``, ``w``; eager times beside them (at the decode
    shape back-to-back eager calls measure the host's overhead)."""
    B, T, W = x.shape
    cw = w.shape[0]
    xt = x.transpose(1, 2)            # [B, W, T], a view
    wt = w.t().contiguous()[:, None]  # [W, 1, cw]

    def lib():
        return F.conv1d(xt, wt, padding=cw - 1, groups=W)
    lib_out = lib()[..., :T].transpose(1, 2)
    scale = max(1.0, float(want.float().abs().max()))
    lib_err = float((lib_out.float() - want.float()).abs().max())
    if lib_err > 3e-2 * scale:
        fail(f"{key}: F.conv1d differs from plain by {lib_err}")
    kern_fn = lambda: conv.causal_conv1d_cuda(x, w)  # noqa: E731
    plain_fn = lambda: conv_ref.causal_conv1d_ref(x, w)  # noqa: E731
    calls = 100 if label == "decode" else 10
    ms = graph_ms(torch, kern_fn, calls)
    plain_ms = graph_ms(torch, plain_fn, calls)
    lib_ms = graph_ms(torch, lib, calls)
    eager = {"eager_ms": time_ms(torch, kern_fn, 100, 10),
             "eager_plain_ms": time_ms(torch, plain_fn, 20, 2),
             "eager_library_ms": time_ms(torch, lib, 100, 10)}
    n = float(B * T * W)
    bound, bound_by = bound_of(
        rates, 2 * n * x.element_size() + w.numel() * w.element_size(),
        2 * cw * n)
    say(f"time {key}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound {bound} ms, "
        f"F.conv1d {lib_ms:.4f} ms; eager calls {eager['eager_ms']:.4f} / "
        f"{eager['eager_plain_ms']:.4f} / {eager['eager_library_ms']:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=bound_by, library_max_abs_err=lib_err, **eager)


def conv_backward_phase(torch, rates, conv, conv_ops, conv_ref):
    """K6's gradient (``ops.CausalConv1dFn``) at the training path's shape
    in bf16: dx and dw against ``torch.autograd.grad`` of the plain
    version (dx: the same taps summed in another order, ``CONV_TOL``; dw:
    B·T products summed in another order, ``CONV_TOL`` of bf16) and
    against one library call (``aten.convolution_backward`` of the
    depthwise conv, 3e-2); device times of its pieces (K6 on the reversed
    cotangent, the two flips, the dw reduction), of the library call, and
    of the plain version's forward and backward.  Returns the row."""
    F = torch.nn.functional
    B, T, W = CONV_SHAPES["train"]
    cw = 4
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn((B, T, W), generator=gen, device="cuda").bfloat16()
    w = (0.3 * torch.randn((cw, W), generator=gen, device="cuda")).bfloat16()
    g = torch.randn((B, T, W), generator=gen, device="cuda").bfloat16()
    key = f"causal_conv1d backward bfloat16 [{B}, {T}, {W}] cw={cw}"
    xa, wa = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    dx, dw = torch.autograd.grad(conv_ops.CausalConv1dFn.apply(xa, wa),
                                 (xa, wa), g)
    xr, wr = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    rdx, rdw = torch.autograd.grad(conv_ref.causal_conv1d_ref(xr, wr),
                                   (xr, wr), g)
    gt = F.pad(g.transpose(1, 2), (0, cw - 1))     # [B, W, T + cw - 1]
    xt, wt = x.transpose(1, 2), w.t().contiguous()[:, None]

    def lib():
        return torch.ops.aten.convolution_backward(
            gt, xt, wt, None, [1], [cw - 1], [1], False, [0], W,
            [True, True, False])
    ldx, ldw, _ = lib()
    torch.cuda.synchronize()
    errs = {}
    for name, got, want, tol in (
            ("dx", dx, rdx, CONV_TOL["bfloat16"]),
            ("dw", dw, rdw, CONV_TOL["bfloat16"]),
            ("library dx", ldx.transpose(1, 2), rdx, 3e-2),
            ("library dw", ldw[:, 0].t(), rdw, 3e-2)):
        if not bool(torch.isfinite(got).all()):
            fail(f"{key}: non-finite {name}")
        e = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        if e > tol * scale:
            fail(f"{key}: max |{name} - plain| = {e} > {tol} * {scale}")
        errs[name] = e
    gf = g.flip(1).contiguous()
    parts = {"k6_ms": graph_ms(torch, lambda: conv.causal_conv1d_cuda(gf, w), 10),
             "flips_ms": graph_ms(torch, lambda: g.flip(1).flip(1), 10),
             "dw_ms": graph_ms(torch, lambda: conv_ops.weight_grad(x, g, cw), 10)}
    n = float(B * T * W)
    # dx and dw: x and g read once, dx written once, w read and dw written
    bound, bound_by = bound_of(rates, 3 * n * 2 + 2 * cw * W * 2, 4 * cw * n)
    row = {"case": key, "shape": [B, T, W], "dtype": "bfloat16",
           "max_abs_err": errs, "ms": sum(parts.values()), **parts,
           "plain_ms": time_ms(torch, lambda: torch.autograd.grad(
               conv_ref.causal_conv1d_ref(xr, wr), (xr, wr), g), 10, 2),
           "library_ms": graph_ms(torch, lib, 10),
           "bound_ms": bound, "bound_by": bound_by}
    say(f"time {key}: {row['ms']:.4f} ms = K6 {parts['k6_ms']:.4f} + flips "
        f"{parts['flips_ms']:.4f} + dw {parts['dw_ms']:.4f} (plain forward and "
        f"backward {row['plain_ms']:.4f} ms eager, convolution_backward "
        f"{row['library_ms']:.4f} ms, bound {bound} ms); max abs err {errs}")
    del x, w, g, xa, wa, xr, wr, dx, dw, rdx, rdw, gt, gf
    torch.cuda.empty_cache()
    return row


def attn_phase(torch, rates, attn, attn_ref, quick: bool):
    """K7 against its plain version on the card in bf16 at each of
    ``ATTN_SHAPES``, with random lengths in [1, S] and with lengths 0, 1, S
    and one past a split boundary: the output of one call (rows of length
    0 must be 0), the split pass's partials of the splits that hold
    positions and the combine pass on the plain partials, each against its
    plain version.  At ``ATTN_TIMED`` (random lengths) the device times
    (CUDA graphs) of a call, of the combine pass alone, of the plain
    version and of ``F.scaled_dot_product_attention`` on the expanded
    cache, and the eager times.  Returns (kernel-line entries: the call
    and the combine pass, at RecurrentGemma's shape; rows)."""
    F = torch.nn.functional
    gen = torch.Generator(device="cuda").manual_seed(7)
    worst, rows, entries = 0.0, [], {}

    def check(key, q, k, v, lengths, splits, chunk):
        S = k.shape[1]
        got = attn.decode_attention_cuda(q, k, v, lengths)
        want = attn_ref.decode_attention_ref(q, k, v, lengths)
        acc, ml = attn.split_cuda(q, k, v, lengths, attn.DEFAULT_BLOCK_S,
                                  splits, chunk)
        racc, rml = attn_ref.split_ref(q, k, v, lengths, splits, chunk)
        comb = attn.combine_cuda(racc, rml, lengths, S, chunk, q.dtype)
        rcomb = attn_ref.combine_ref(racc, rml, lengths, S, chunk, q.dtype)
        torch.cuda.synchronize()
        live = lengths > 0
        if got.shape != q.shape or not bool(torch.isfinite(got).all()) \
                or not bool((got[~live] == 0).all()):
            fail(f"{key}: output {tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got).all())}, rows of length 0 not 0")
        err = check_out(torch, key, {"o": got[live]}, {"o": want[live]},
                        lambda m: ATTN_TOL * m) if bool(live.any()) else 0.0
        # the partials of the splits that hold positions (f32)
        used = (torch.arange(splits, device="cuda")[None]
                < ((lengths.clamp(0, S) + chunk - 1) // chunk)[:, None])
        sel = used[:, None, :].expand(-1, k.shape[2], -1)
        part_err = check_out(torch, f"{key} split partials",
                             {"acc": acc[sel], "ml": ml[sel]},
                             {"acc": racc[sel], "ml": rml[sel]},
                             lambda m: ATTN_PART_TOL * m) if bool(sel.any()) else 0.0
        comb_err = check_out(torch, f"{key} combine", {"o": comb},
                             {"o": rcomb}, lambda m: ATTN_TOL * m)
        say(f"kernel {key} ({splits} splits of {chunk}): max abs err "
            f"{err:.3g}; partials {part_err:.3g}, combine {comb_err:.3g}")
        return max(err, comb_err), {"case": key, "max_abs_err": err,
                                    "partials_max_abs_err": part_err,
                                    "combine_max_abs_err": comb_err,
                                    "splits": splits, "chunk": chunk,
                                    "lengths": lengths.tolist()}

    for label, (B, H, K, hd, S) in ATTN_SHAPES.items():
        G = H // K
        q = torch.randn((B, H, hd), generator=gen, device="cuda").bfloat16()
        k = torch.randn((B, S, K, hd), generator=gen, device="cuda").bfloat16()
        v = torch.randn((B, S, K, hd), generator=gen, device="cuda").bfloat16()
        splits, chunk = attn.split_plan(B, K, S, attn.DEFAULT_BLOCK_S,
                                        attn.sm_count(0))
        special = [0, 1, S, chunk + 1]
        cases = [torch.randint(1, S + 1, (B,), generator=gen, device="cuda",
                               dtype=torch.int32)]
        # lengths 0, 1, S and one past a split boundary: one row each
        cases += ([torch.tensor(special + [S] * (B - 4), dtype=torch.int32,
                                device="cuda")] if B >= 4 else
                  [torch.full((B,), n, dtype=torch.int32, device="cuda")
                   for n in special])
        for i, lengths in enumerate(cases):
            key = (f"decode_attention bf16 {label} B={B} H={H} K={K} hd={hd} "
                   f"S={S} lengths {'random' if i == 0 else lengths.tolist()}")
            err, row = check(key, q, k, v, lengths, splits, chunk)
            worst = max(worst, err)
            rows.append(row)
        lengths = cases[0]
        if label in ATTN_TIMED and not quick:
            # the expanded cache [B, H, S, hd] and the key mask, made once
            ke = k.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
            ve = v.permute(0, 2, 1, 3).repeat_interleave(G, dim=1).contiguous()
            mask = (torch.arange(S, device="cuda")[None]
                    < lengths[:, None])[:, None, None]
            qe = q[:, :, None]

            def lib():
                return F.scaled_dot_product_attention(qe, ke, ve,
                                                      attn_mask=mask)
            want = attn_ref.decode_attention_ref(q, k, v, lengths)
            scale = max(1.0, float(want.float().abs().max()))
            lib_err = float((lib()[:, :, 0].float() - want.float()).abs().max())
            if lib_err > ATTN_TOL * scale:
                fail(f"{label}: scaled_dot_product_attention differs from "
                     f"plain by {lib_err}")
            acc, ml = attn.split_cuda(q, k, v, lengths, attn.DEFAULT_BLOCK_S,
                                  splits, chunk)

            def kern_fn():
                return attn.decode_attention_cuda(q, k, v, lengths)

            def plain_fn():
                return attn_ref.decode_attention_ref(q, k, v, lengths)

            def comb_fn():
                return attn.combine_cuda(acc, ml, lengths, S, chunk, q.dtype)

            def comb_plain():
                return attn_ref.combine_ref(acc, ml, lengths, S, chunk, q.dtype)
            # device times from CUDA graphs: a call is two launches of a
            # few microseconds, below the host's cost of enqueueing it
            ms = graph_ms(torch, kern_fn)
            plain_ms = graph_ms(torch, plain_fn, 20)
            lib_ms = graph_ms(torch, lib)
            comb_ms = graph_ms(torch, comb_fn)
            comb_plain_ms = graph_ms(torch, comb_plain, 20)
            eager = {"eager_ms": time_ms(torch, kern_fn, 100, 10),
                     "eager_plain_ms": time_ms(torch, plain_fn, 20, 2),
                     "eager_library_ms": time_ms(torch, lib, 100, 10)}
            n_pos = float(lengths.sum())
            n_kv = n_pos * K * hd                     # cache values read, each
            bound, bound_by = bound_of(
                rates, 2 * (2 * n_kv + 2 * q.numel()), 4 * n_pos * H * hd)
            n_part = float(((lengths + chunk - 1) // chunk).sum()) * K * G
            comb_bound, comb_by = bound_of(
                rates, 4 * n_part * (hd + 2) + 2 * q.numel(), 3 * n_part * hd)
            say(f"time decode_attention bf16 {label}: {ms:.4f} ms a call, "
                f"device (plain {plain_ms:.4f} ms, bound {bound} ms, "
                f"scaled_dot_product_attention {lib_ms:.4f} ms; eager calls "
                f"{eager['eager_ms']:.4f} / {eager['eager_plain_ms']:.4f} / "
                f"{eager['eager_library_ms']:.4f} ms); combine pass "
                f"{comb_ms:.4f} ms (plain {comb_plain_ms:.4f} ms, bound "
                f"{comb_bound} ms); {splits} splits of {chunk}")
            if ms > lib_ms:
                say(f"NOTE: K7 ({ms:.4f} ms) is slower than "
                    f"scaled_dot_product_attention ({lib_ms:.4f} ms) at {label}")
            rows[-len(cases)].update(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                bound_by=bound_by, library_max_abs_err=lib_err,
                combine_ms=comb_ms, combine_plain_ms=comb_plain_ms,
                combine_bound_ms=comb_bound, lengths_sum=int(n_pos), **eager)
            if label == "recurrentgemma":
                src = "src/repro_torch/kernels/decode_attn/csrc/decode_attn.cu"
                entries["decode_attention"] = {
                    "name": "decode_attention", "route": "cuda", "source": src,
                    "replaces": REPLACES["decode_attention"], "launches": None,
                    "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound, "bound_by": bound_by,
                    "library_ms": lib_ms, "shape": [B, H, K, hd, S],
                    "lengths_sum": int(n_pos), "splits": splits,
                    "chunk": chunk, **eager}
                entries["decode_attention.combine"] = {
                    "name": "decode_attention.combine", "route": "cuda",
                    "source": src, "replaces": REPLACES["decode_attention"],
                    "launches": None, "max_abs_err": None, "ms": comb_ms,
                    "plain_ms": comb_plain_ms, "bound_ms": comb_bound,
                    "bound_by": comb_by, "library_ms": None,
                    "shape": [B, H, K, hd, S]}
            del ke, ve, mask, acc, ml
        del q, k, v
    for e in entries.values():
        e["max_abs_err"] = worst
    torch.cuda.empty_cache()
    return entries, rows


def profile_steps(torch, api, cfg, params, cache, toks, steps: int):
    """Device time of ``steps`` decode steps under ``torch.profiler``: the
    sum of the kernels' device time, K6's share of it and the kernels that
    take the most, against the wall time of the window (which the profiler
    lengthens on the host)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in range(steps):
            _, cache = api.decode_step(cfg, params, cache, toks[:, s:s + 1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return float(getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0)))
    # the kernels' own entries (an operator's entry repeats its kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    k6 = sum(dev_us(e) for e in events if "causal_conv1d" in e.key)
    top = sorted(events, key=dev_us, reverse=True)[:8]
    return {"steps": steps, "wall_ms_per_step": 1e3 * wall / steps,
            "device_ms_per_step": total / 1e3 / steps if total else None,
            "device_busy_share": total / 1e6 / wall if total else None,
            "k6_device_ms_per_step": k6 / 1e3 / steps if total else None,
            "k6_share_of_device": k6 / total if total else None,
            "top_kernels": [(e.key[:80], dev_us(e) / 1e3 / steps, e.count // steps)
                            for e in top]}


def serve_phase(torch, np, mods, counters):
    """Phase 8: serve ``SERVE_ARCH`` through ``BatchServer`` on the card;
    checks the launch counts, the tokens, the first decode steps against
    the plain K6, and K7 against ``_sdpa`` on the served cache; then
    profiles decode steps with ``torch.profiler``.  Returns the record of
    the phase."""
    configs, api, griffin, L = (mods["configs"], mods["api"], mods["griffin"],
                                mods["layers"])
    serve_loop, conv, conv_ref, attn = (mods["serve_loop"], mods["conv"],
                                        mods["conv_ref"], mods["attn"])
    reset_counts, counts = counters
    cfg = configs.get(SERVE_ARCH)
    n_rec = griffin.block_types(cfg).count("rec")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = api.param_count(cfg)
    say(f"serving {cfg.name}: {cfg.n_layers} layers ({n_rec} recurrent), "
        f"d_model {cfg.d_model}, rnn {cfg.rnn_width}, vocab {cfg.vocab}, "
        f"{n_params} parameters (f32, {torch.cuda.memory_allocated() / 1e9:.1f}"
        f" GB on the card) drawn in {init_s:.1f} s; compute {cfg.dtype}")

    rng = np.random.default_rng(0)
    lo, hi = SERVE_PROMPT_LEN
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(lo, hi + 1)))
               .astype(np.int32) for _ in range(SERVE_REQUESTS)]

    # the first decode steps of the first wave, with K6 and with its plain
    # version (comparison launches: outside the main path's count)
    S1 = max(len(p) for p in prompts[:SERVE_BATCH])
    toks = np.zeros((SERVE_BATCH, S1), np.int32)
    for i, p in enumerate(prompts[:SERVE_BATCH]):
        toks[i, S1 - len(p):] = p
    toks = torch.as_tensor(toks, device="cuda")
    cache_len = api.decode_cache_len(cfg, 32)
    caches = {flag: api.init_cache(cfg, SERVE_BATCH, cache_len)
              for flag in (None, False)}
    step_ms, host_ms, wait_ms, worst, agree = [], [], [], 0.0, 0
    for s in range(SERVE_CHECK_STEPS):
        out = {}
        for flag in (None, False):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            start.record()
            logits, caches[flag] = api.decode_step(
                cfg, params, caches[flag], toks[:, s:s + 1],
                use_kernel_conv=flag)
            end.record()
            h1 = time.perf_counter()
            torch.cuda.synchronize()
            if flag is None:
                # host time to enqueue the step, and how long the device
                # ran on after the host had finished enqueueing
                step_ms.append(start.elapsed_time(end))
                host_ms.append(1e3 * (h1 - h0))
                wait_ms.append(1e3 * (time.perf_counter() - h1))
            out[flag] = logits[:, -1].float()
        got, want = out[None], out[False]
        if got.shape != (SERVE_BATCH, cfg.vocab) \
                or not bool(torch.isfinite(got).all()):
            fail(f"serving step {s}: logits {tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        err = float((got - want).abs().max())
        scale = max(1.0, float(want.abs().max()))
        if err > SERVE_LOGITS_TOL * scale:
            fail(f"serving step {s}: max |logits(K6) - logits(plain)| = {err} "
                 f"> {SERVE_LOGITS_TOL} * {scale}")
        worst = max(worst, err)
        agree += int((got.argmax(-1) == want.argmax(-1)).sum())
    say(f"serving: first {SERVE_CHECK_STEPS} decode steps, K6 vs plain "
        f"conv: max |logits diff| {worst:.3g}, greedy tokens agree "
        f"{agree}/{SERVE_CHECK_STEPS * SERVE_BATCH}; ms a step (CUDA events) "
        f"{', '.join(f'{m:.2f}' for m in step_ms)}, of which the host "
        f"enqueued for {', '.join(f'{m:.2f}' for m in host_ms)} and the "
        f"device ran on {', '.join(f'{m:.2f}' for m in wait_ms)}")
    del caches, logits, out, got, want

    # -- the main path --------------------------------------------------------
    server = serve_loop.BatchServer(
        cfg, params, batch_size=SERVE_BATCH,
        gen=serve_loop.GenConfig(max_new_tokens=SERVE_MAX_NEW))
    for p in prompts:
        server.submit(p, SERVE_MAX_NEW)
    waves = [prompts[i:i + SERVE_BATCH]
             for i in range(0, len(prompts), SERVE_BATCH)]
    # a wave's context is bucketed to a power of two; one decode step per
    # context position but the last
    steps = sum((1 << max(1, (max(len(p) for p in w) + SERVE_MAX_NEW - 1)
                          .bit_length())) - 1 for w in waves)
    torch.cuda.synchronize()
    reset_counts()
    conv_ref.causal_conv1d_ref.calls = 0
    t0 = time.perf_counter()
    done = server.run_until_drained()
    wall = time.perf_counter() - t0
    seen = counts()
    plain_calls = conv_ref.causal_conv1d_ref.calls
    if seen["causal_conv1d"] != n_rec * steps or plain_calls \
            or sum(seen.values()) != seen["causal_conv1d"]:
        fail(f"serving: launch counts {seen} and {plain_calls} calls of K6's "
             f"plain version over {steps} decode steps; expected "
             f"{n_rec} x {steps} of causal_conv1d and nothing else")
    results = [done[uid].result for uid in sorted(done)]
    if len(results) != SERVE_REQUESTS or any(
            len(r) != SERVE_MAX_NEW or (r < 0).any() or (r >= cfg.vocab).any()
            for r in results):
        fail(f"serving: results {results}")
    lat = np.array([r.done_at - r.submitted_at for r in done.values()])
    n_tok = sum(len(r) for r in results)
    cache = server.generator.cache
    for i, st in enumerate(cache["blocks"]):
        for name, t in st.items():
            if not bool(torch.isfinite(t.float()).all()):
                fail(f"serving: non-finite cache '{name}' of layer {i}")
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "requests": SERVE_REQUESTS, "batch_size": SERVE_BATCH,
           "max_new_tokens": SERVE_MAX_NEW, "waves": len(waves),
           "decode_steps": steps, "new_tokens": n_tok, "seconds": wall,
           "tokens_per_s": n_tok / wall, "ms_per_decode_step": 1e3 * wall / steps,
           "event_ms_per_decode_step": step_ms,
           "host_enqueue_ms_per_decode_step": host_ms,
           "device_after_host_ms_per_decode_step": wait_ms,
           "latency_p50_s": float(np.percentile(lat, 50)),
           "latency_max_s": float(lat.max()),
           "launches": seen, "k6_launches": seen["causal_conv1d"],
           "k6_launches_per_step": seen["causal_conv1d"] / steps,
           "k6_vs_plain_logits_max_abs_diff": worst,
           "k6_vs_plain_greedy_agree": agree,
           "init_s": init_s,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_results": [r.tolist() for r in results[:2]]}
    say(f"serving main path: {SERVE_REQUESTS} requests in {len(waves)} waves, "
        f"{steps} decode steps, {n_tok} new tokens in {wall:.3f} s = "
        f"{row['tokens_per_s']:.2f} tokens/s, {row['ms_per_decode_step']:.2f} "
        f"ms a decode step (wall); latency p50 {row['latency_p50_s']:.3f} s, "
        f"max {row['latency_max_s']:.3f} s; K6 {seen['causal_conv1d']} "
        f"launches = {n_rec} x {steps}; peak {row['peak_gb']:.1f} GB")

    # -- K7 against the model's attention on the served cache -----------------
    li = griffin.block_types(cfg).index("attn")
    k, v = cache["blocks"][li]["k"], cache["blocks"][li]["v"]
    B, Sc, K, hd = k.shape
    pos = cache["pos"] - 1                  # the last decoded position
    gen = torch.Generator(device="cuda").manual_seed(8)
    q = torch.randn((B, cfg.n_heads, hd), generator=gen,
                    device="cuda").to(k.dtype)
    lengths = torch.full((B,), min(pos + 1, Sc), dtype=torch.int32,
                         device="cuda")
    positions = torch.full((B, 1), pos, device="cuda")
    k_pos = L.cache_abs_pos(pos, Sc, "cuda").expand(B, Sc)
    mask = L._mask(positions, k_pos, "causal", cfg.local_window)[:, None]
    if int(mask.sum()) != B * min(pos + 1, Sc):
        fail("serving cache: the valid slots are not min(pos + 1, Sc)")
    want = L._sdpa(q[:, None], k, v, mask, hd ** -0.5)[:, 0]
    got = attn.decode_attention_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not bool(torch.isfinite(got).all()) or err > SDPA_TOL * scale:
        fail(f"K7 vs _sdpa on layer {li}'s served cache: max |diff| = {err} "
             f"> {SDPA_TOL} * {scale}")
    say(f"K7 vs _sdpa on layer {li}'s served cache (B={B}, Sc={Sc}, pos={pos},"
        f" lengths {min(pos + 1, Sc)}): max abs diff {err:.3g}")
    row["k7_vs_sdpa_max_abs_diff"] = err
    prof = profile_steps(torch, api, cfg, params,
                         api.init_cache(cfg, SERVE_BATCH, cache_len), toks,
                         SERVE_CHECK_STEPS)
    row["profile"] = prof
    say(f"serving profile ({prof['steps']} decode steps): wall "
        f"{prof['wall_ms_per_step']:.2f} ms a step, device "
        f"{prof['device_ms_per_step']} ms a step (busy share "
        f"{prof['device_busy_share']}), K6 {prof['k6_device_ms_per_step']} "
        f"ms a step ({prof['k6_share_of_device']} of the device time); "
        f"top kernels {prof['top_kernels']}")
    del params, server, cache, k, v
    torch.cuda.empty_cache()
    return row


def kernel_kind(name: str) -> str:
    """A device kernel's kind, from its name: K6, matrix products, copies
    and casts, reductions, other elementwise work."""
    n = name.lower()
    if "causal_conv1d" in n:
        return "K6"
    if any(k in n for k in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
        return "products"
    if "copy" in n:
        return "copies and casts"
    if any(k in n for k in ("reduce", "softmax", "logsumexp", "norm")):
        return "reductions"
    if "elementwise" in n:
        return "elementwise"
    return "other"


def profile_train_step(torch, step_fn, state, batch):
    """One training step under ``torch.profiler``: the kernels' device
    time, K6's (its kernels by name: forward, recompute and dx) and the
    flips' (``aten::flip``, the two copies of each dx), and the kernels
    that take the most; returns (record, state after the step)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e, own=True):
        name = "self_device_time_total" if own else "device_time_total"
        return float(getattr(e, name, getattr(e, name.replace("device", "cuda"),
                                               0.0)))
    avgs = prof.key_averages()
    events = [e for e in avgs
              if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0]
    total = sum(dev_us(e) for e in events)
    k6 = [e for e in events if "causal_conv1d" in e.key]
    flips = [e for e in avgs if e.key == "aten::flip"]
    top = sorted(events, key=dev_us, reverse=True)[:25]
    by_kind = {}
    for e in events:
        k = kernel_kind(e.key)
        by_kind[k] = by_kind.get(k, 0.0) + dev_us(e) / 1e3
    rec = {"wall_ms": 1e3 * wall,
           "device_ms_by_kind": by_kind,
           "device_ms": total / 1e3 if total else None,
           "device_busy_share": total / 1e6 / wall if total else None,
           "k6_device_ms": sum(dev_us(e) for e in k6) / 1e3,
           "k6_kernel_launches": sum(e.count for e in k6),
           "flip_device_ms": sum(dev_us(e, own=False) for e in flips) / 1e3,
           "flip_calls": sum(e.count for e in flips),
           "loss": float(metrics["loss"]),
           "top_kernels": [(e.key[:90], dev_us(e) / 1e3, e.count) for e in top]}
    return rec, state


def describe(b, fuse) -> str:
    """A tune candidate in one word: template, tile, depth, window."""
    if b.kind == "torch":
        return f"torch f{fuse}"
    tile = "x".join(map(str, b.block)) if b.block else "default"
    return f"{b.template}[{tile}] k{b.time_block} f{fuse}"


def autotune_phase(torch, mods, counters, main_rows):
    """Phase 10: tune star3d4r and acoustic ISO at 512³ f32, exhaustively
    and in two stages (top_k=3), each candidate's prediction beside its
    measured time; with star3d4r's rates, the shortlist acoustic would get;
    then each main path through ``st.launch(autotune=True)`` (in-process
    hit), and again after the in-process cache and the cost models are
    dropped (disk hit: nothing measured).  Returns the phase's record and
    the two-stage winner of each workload."""
    st, suite, acoustic = mods["st"], mods["suite"], mods["acoustic"]
    at, cm, tl = mods["autotune"], mods["cost_model"], mods["timeloop"]
    reset_counts, counts = counters
    shutil.rmtree(AUTOTUNE_CACHE, ignore_errors=True)
    cdir = str(AUTOTUNE_CACHE)
    at.clear_cache()
    cm.reset_default_models()
    rows, star_rates, winners = [], None, {}
    classes = ("torch", "hopper-K1", "hopper-K2", "hopper-K3", "hopper-K5")
    for wname in ("star3d4r", "acoustic_iso"):
        if wname == "star3d4r":
            k, swap, scal = suite.get_kernel("star3d4r"), ("v", "u"), {}

            def fresh():
                return suite.make_grids("star3d4r", MAIN_SHAPE, seed=0)

            def launch(grids, **kw):
                return st.launch(**kw)(lambda u, v: st.timeloop(
                    STEPS, swap=("v", "u"))(k)(u, v))(grids["u"], grids["v"])
        else:
            k, swap = acoustic.acoustic_iso_kernel, ("p0", "p1")

            def fresh():
                p0, p1, vp2, damp, dt = acoustic.make_fields(MAIN_SHAPE,
                                                             pml_width=PML_WIDTH)
                acoustic.inject_source(p1, 0)
                return {"p0": p0, "p1": p1, "vp2": vp2, "damp": damp, "dt": dt}

            def launch(f, **kw):
                def between(t, grids):
                    acoustic.inject_source(grids["p1"], t)
                return st.launch(fuse_steps=ACOUSTIC_FUSE, **kw)(
                    acoustic.acoustic_target_fused)(
                    f["p0"], f["p1"], f["vp2"], f["damp"], f["dt"], STEPS,
                    between=between)
        fields = fresh()
        grids = {g: fields[g] for g in k.ir.grid_params}
        scal = {n: fields[n] for n, _ in k.ir.scalar_params}
        tune_kw = dict(iters=1, swap=swap, steps=AUTOTUNE_STEPS, scalars=scal)
        t0 = time.perf_counter()
        two = at.tune(k, grids, top_k=AUTOTUNE_TOP_K, cache_dir=cdir, **tune_kw)
        cold_s = time.perf_counter() - t0
        model = cm.default_model(cdir, "cuda")
        ex = at.tune(k, grids, top_k=None, cost_model=model, **tune_kw)
        probe = cm._Probe(k, grids, swap, scal)
        rates = {c: model.rate_for(c, torch.float32, probe) for c in classes}
        for c, r in rates.items():
            say(f"autotune {wname}: rate {c} {r.bytes_per_s / 1e12:.4f} TB/s, "
                f"overhead {r.overhead_s * 1e6:.1f} us (key "
                f"{cm.rate_key(c, torch.float32, probe)})")
        measured = {(b.cache_key(), f): s for b, f, s in ex.trials}
        shortlist = {(b.cache_key(), f) for b, f, _ in two.trials}
        order = sorted(range(len(ex.predicted)), key=lambda i: (
            ex.predicted[i][2], i))
        cands = []
        for rank, i in enumerate(order):
            b, f, p = ex.predicted[i]
            m = measured[(b.cache_key(), f)]
            cands.append({"candidate": describe(b, f), "predicted_s": p,
                          "measured_s": m, "predicted_rank": rank,
                          "shortlisted": (b.cache_key(), f) in shortlist})
            say(f"  {'*' if cands[-1]['shortlisted'] else ' '} "
                f"{describe(b, f):34s} predicted {p:.6f} s, measured {m:.6f} s")
        ratio = two.seconds / ex.seconds
        in_ex = measured[(two.backend.cache_key(), two.fuse_steps)] / ex.seconds
        say(f"autotune {wname} {MAIN_SHAPE}: exhaustive winner "
            f"{describe(ex.backend, ex.fuse_steps)} {ex.seconds:.6f} s "
            f"(rank_error {ex.rank_error}, {ex.measured_candidates} measured); "
            f"two-stage winner {describe(two.backend, two.fuse_steps)} "
            f"{two.seconds:.6f} s = {ratio:.3f}x ({in_ex:.3f}x in the "
            f"exhaustive run; rank_error {two.rank_error}, "
            f"{two.pruned_candidates} pruned); cold two-stage tune "
            f"{cold_s:.2f} s (calibrate {two.timing['calibrate']:.2f}, "
            f"predict {two.timing['predict']:.2f}, build "
            f"{two.timing['build']:.2f}, measure {two.timing['measure']:.2f}); "
            f"exhaustive build {ex.timing['build']:.2f}, measure "
            f"{ex.timing['measure']:.2f}")
        if not ratio <= AUTOTUNE_RATIO:
            fail(f"autotune {wname}: the two-stage winner takes {ratio:.3f}x "
                 f"the exhaustive winner's time (limit {AUTOTUNE_RATIO})")
        row = {"workload": wname, "candidates": cands, "rates": {
            c: [r.bytes_per_s, r.overhead_s] for c, r in rates.items()},
               "exhaustive": {"winner": describe(ex.backend, ex.fuse_steps),
                              "seconds": ex.seconds, "rank_error": ex.rank_error,
                              "timing": ex.timing},
               "two_stage": {"winner": describe(two.backend, two.fuse_steps),
                             "seconds": two.seconds, "ratio": ratio,
                             "ratio_in_exhaustive": in_ex,
                             "rank_error": two.rank_error,
                             "pruned": two.pruned_candidates,
                             "timing": two.timing, "cold_s": cold_s}}
        # the shortlists other rates would give: one rate for every hopper
        # class (K1's), and, for acoustic, the rates probed on star3d4r
        others = {"one hopper class": {c: rates["hopper-K1"] if c.startswith(
            "hopper") else r for c, r in rates.items()}}
        if star_rates is None:
            star_rates = rates
        else:
            others["star3d4r's rates"] = star_rates
        for label, alt in others.items():
            cf = cm.CostModel(calibrate=False, device="cuda", rates={
                cm.rate_key(c, torch.float32, probe): r for c, r in alt.items()})
            preds = [cf.predict(k, grids, b, f, AUTOTUNE_STEPS, swap,
                                scalars=scal) for b, f, _ in ex.predicted]
            picked = [ex.predicted[i] for i in
                      at.shortlist_indices(preds, AUTOTUNE_TOP_K)]
            best = min(measured[(b.cache_key(), f)] for b, f, _ in picked)
            row[f"shortlist with {label}"] = {
                "candidates": [describe(b, f) for b, f, _ in picked],
                "best_measured_s": best, "ratio": best / ex.seconds}
            say(f"autotune {wname}: with {label} the shortlist would be "
                f"{[describe(b, f) for b, f, _ in picked]}, best measured "
                f"{best:.6f} s = {best / ex.seconds:.3f}x the exhaustive winner")
        del grids, fields, probe
        torch.cuda.empty_cache()

        ref = fresh()
        launch(ref, backend=st.torch())
        for label in ("in-process", "disk"):
            if label == "disk":
                at.clear_cache()
                cm.reset_default_models()
            before = dict(at.MEASURE_COUNT)
            f = fresh()
            reset_counts()
            res = launch(f, autotune=True, autotune_cache=cdir)
            seen = counts()
            if dict(at.MEASURE_COUNT) != before:
                fail(f"autotune {wname} {label}: the launch measured "
                     f"{at.MEASURE_COUNT} (before {before})")
            be, fuse = two.backend, res.value.fuse_steps
            want = {}
            if be.kind == "hopper":
                halos = {g: f[g].halo for g in k.ir.grid_params}
                plan, plan1 = tl.hopper_plans(k.ir, halos, MAIN_SHAPE, be, swap)
                blocked, single, _ = tl.launch_steps(STEPS, fuse, plan.time_block)
                if blocked:
                    want[KIND_WRAPPER[plan.kind]] = blocked // plan.time_block
                if single:
                    name = KIND_WRAPPER[plan1.kind]
                    want[name] = want.get(name, 0) + single
            if {g: c for g, c in seen.items() if c} != want:
                fail(f"autotune {wname} {label}: launch counts {seen}, "
                     f"expected {want}")
            diff, scale = max_diff(torch, f"autotune {wname} {label}",
                                   {g: f[g] for g in swap},
                                   {g: ref[g] for g in swap})
            fixed = max((r for r in main_rows if r["path"].endswith(f"[{wname}]")),
                        key=lambda r: r["steps_per_s"])
            row[label] = {"launches": seen, "steps_per_s": res.value.steps_per_s,
                          "tune_s": res.profile["autotune"],
                          "max_abs_diff_vs_torch": diff, "field_max": scale,
                          "best_fixed": [fixed["path"], fixed["steps_per_s"]]}
            say(f"autotune main path {wname} ({label} hit, tune "
                f"{res.profile['autotune']:.3f} s): {describe(be, fuse)}, "
                f"{STEPS} steps at {res.value.steps_per_s:.1f} steps/s (best "
                f"fixed build in phase 4: {fixed['path']} "
                f"{fixed['steps_per_s']:.1f}); launches {want}; max |diff| vs "
                f"st.torch() {diff:.3g} (field max {scale:.3g})")
            del f
        del ref
        torch.cuda.empty_cache()
        rows.append(row)
        winners[wname] = two.backend
    return rows, winners


def train_phase(torch, mods, counters):
    """Phase 9: train ``TRAIN_ARCH`` at its published widths (depth
    ``TRAIN_LAYERS``, batch ``TRAIN_BATCH``, seq ``TRAIN_SEQ``) on the card:
    the first step's loss and gradient with K6 and with its plain version
    (outside the main path's count), then ``TRAIN_STEPS`` AdamW steps of
    ``make_train_step`` on ``train/data.py`` batches as the main path (K6
    launched 3 times a recurrent layer a step: forward, recompute, dx;
    nothing else), one more step under ``torch.profiler``.  Returns the
    record of the phase."""
    import dataclasses
    configs, train_loop, optimizer, data, shapes, griffin, conv_ref = (
        mods["configs"], mods["train_loop"], mods["optimizer"], mods["data"],
        mods["shapes"], mods["griffin"], mods["conv_ref"])
    reset_counts, counts = counters
    cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    types = griffin.block_types(cfg)
    n_rec = types.count("rec")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = train_loop.init_state(cfg, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in optimizer.tree_leaves(state["params"]))
    say(f"training {cfg.name} cut to {cfg.n_layers} layers ({types}): d_model "
        f"{cfg.d_model}, rnn {cfg.rnn_width}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, attn_chunk {cfg.attn_chunk}, logits_chunk "
        f"{cfg.logits_chunk}, remat {cfg.remat_policy if cfg.remat else None};"
        f" {n_params} parameters (f32 params and AdamW moments, "
        f"{torch.cuda.memory_allocated() / 1e9:.1f} GB) drawn in {init_s:.1f} s;"
        f" batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, compute {cfg.dtype}")
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)

    # the first step's loss and conv_w gradients, with K6 and with its plain
    # version (comparison launches: outside the main path's count)
    dev = optimizer.tree_leaves(state["params"])[0].device
    b0 = {k: torch.as_tensor(v, device=dev) for k, v in batch_fn(0).items()}
    rec_layers = [i for i, t in enumerate(types) if t == "rec"]
    first = {}
    for flag in (None, False):
        loss, grads = train_loop.make_loss_and_grad(cfg, flag)(state["params"], b0)
        first[flag] = (float(loss), [grads["blocks"][i]["mix"]["conv_w"].clone()
                                     for i in rec_layers])
        del grads
    torch.cuda.synchronize()
    (lk, gk), (lp, gp) = first[None], first[False]
    if not (math.isfinite(lk) and abs(lk - lp) <= TRAIN_LOSS_RTOL * abs(lp)):
        fail(f"training: first-step loss with K6 {lk}, with its plain version "
             f"{lp} (limit {TRAIN_LOSS_RTOL} of it)")
    grad_err = 0.0
    for i, a, b in zip(rec_layers, gk, gp):
        e = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not bool(torch.isfinite(a).all()) or e > TRAIN_GRAD_TOL * scale:
            fail(f"training: layer {i}'s conv_w gradient with K6 differs from "
                 f"the plain version's by {e} (limit {TRAIN_GRAD_TOL} of {scale})")
        grad_err = max(grad_err, e / scale)
    say(f"training: first step, K6 vs its plain version: loss {lk!r} vs {lp!r}"
        f" (relative {abs(lk - lp) / abs(lp):.3g}); conv_w gradients "
        f"{grad_err:.3g} of their max apart")
    del first, gk, gp, b0

    # -- the main path --------------------------------------------------------
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(
        warmup_steps=1, total_steps=TRAIN_STEPS))
    step_fn = train_loop.make_train_step(cfg, tc)
    batches = [batch_fn(s) for s in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    reset_counts()
    conv_ref.causal_conv1d_ref.calls = 0
    step_s, losses, gnorms = [], [], []
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batches[s])
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    seen = counts()
    plain_calls = conv_ref.causal_conv1d_ref.calls
    want = 3 * n_rec * TRAIN_STEPS
    if seen["causal_conv1d"] != want or plain_calls \
            or sum(seen.values()) != seen["causal_conv1d"]:
        fail(f"training: launch counts {seen} and {plain_calls} calls of K6's "
             f"plain version over {TRAIN_STEPS} steps; expected {want} of "
             f"causal_conv1d (3 x {n_rec} recurrent layers a step) and "
             f"nothing else")
    if not all(math.isfinite(v) for v in losses + gnorms) \
            or abs(losses[0] - lk) > TRAIN_LOSS_RTOL * abs(lk):
        fail(f"training: losses {losses} (first step's {lk} before), "
             f"gradient norms {gnorms}")
    for name, t in zip(("params", "m", "v"), (state["params"], state["opt"]["m"],
                                              state["opt"]["v"])):
        if not all(bool(torch.isfinite(x).all())
                   for x in optimizer.tree_leaves(t)):
            fail(f"training: non-finite {name} after {TRAIN_STEPS} steps")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "init_s": init_s, "step_s": step_s, "ms_per_step": 1e3 * steady,
           "tokens_per_s": tokens / steady, "losses": losses,
           "grad_norms": gnorms, "launches": seen,
           "k6_launches": seen["causal_conv1d"],
           "first_step_loss_kernel": lk, "first_step_loss_plain": lp,
           "conv_w_grad_rel_diff": grad_err,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    say(f"training main path: {TRAIN_STEPS} steps of {tokens} tokens, "
        f"{', '.join(f'{1e3 * t:.1f}' for t in step_s)} ms a step (wall); "
        f"steady {row['ms_per_step']:.1f} ms = {row['tokens_per_s']:.0f} "
        f"tokens/s; losses {losses}; K6 {seen['causal_conv1d']} launches = 3 x "
        f"{n_rec} x {TRAIN_STEPS}; peak {row['peak_gb']:.1f} GB")
    prof, state = profile_train_step(torch, step_fn, state, batches[-1])
    row["profile"] = prof
    say(f"training profile (one step): wall {prof['wall_ms']:.1f} ms, device "
        f"{prof['device_ms']} ms (busy share {prof['device_busy_share']}; by "
        f"kind {prof['device_ms_by_kind']}); K6 "
        f"{prof['k6_device_ms']:.4f} ms in {prof['k6_kernel_launches']} "
        f"launches, flips {prof['flip_device_ms']:.4f} ms in "
        f"{prof['flip_calls']} calls; top kernels {prof['top_kernels'][:10]}")
    del state, batches
    torch.cuda.empty_cache()
    return row


def shot_models(torch, acoustic, nb: int, device):
    """Phase 11's shots: each a source position (``BATCH_SOURCES``) and its
    own model, the background vp² of ``make_fields`` with a slow blob
    (``BLOB_RADIUS`` cells, vp² lower by ``BLOB_DVP2``) ``BLOB_OFFSET``
    cells beside its source along axis 2, where the wave reaches it within
    the run's steps.  Returns (positions, vp² interiors (nb, *MAIN_SHAPE)
    on ``device``, the blob of shot 0 as a 0/1 mask)."""
    pos = BATCH_SOURCES[:nb]
    ax = [torch.arange(n, device=device, dtype=torch.float32) for n in MAIN_SHAPE]
    vp2 = torch.full((nb,) + MAIN_SHAPE, 1.5 ** 2, device=device)
    blobs = []
    for b, (x, y, z) in enumerate(pos):
        r2 = ((ax[0] - x)[:, None, None] ** 2 + (ax[1] - y)[None, :, None] ** 2
              + (ax[2] - z - BLOB_OFFSET)[None, None, :] ** 2)
        blob = (r2 <= BLOB_RADIUS ** 2).float()
        vp2[b] -= BLOB_DVP2 * blob
        blobs.append(blob)
    return pos, vp2, blobs[0]


def batch_phase(torch, mods, counters, main_rows, entries, device="cuda"):
    """Phase 11 (a): batched scenarios at 512³ f32.  Acoustic ISO, B = 4
    shots (``shot_models``), 100 steps in windows of 10 with each shot's
    source injected in ``between``, under K1, K2, K3 (k=2) and K5: each
    shot equal bit for bit to its own unbatched run under the same build,
    within ``END_TO_END_RTOL`` of its max of the batched ``st.torch()``
    run, and exactly as many launches as the unbatched path (one launch
    advances every shot); ``star3d4r`` with B = 2 under K2 the same way;
    then per-scenario ``(B, NS)`` scalars (a dt a shot) at the small shapes,
    one launch of each kernel against its plain version.  Returns the
    phase's record."""
    st, acoustic, suite, codegen = (mods["st"], mods["acoustic"], mods["suite"],
                                    mods["codegen"])
    wrappers = mods["wrappers"]
    reset_counts, counts = counters
    nb = BATCH_SHOTS
    pos, vp2s, _ = shot_models(torch, acoustic, nb, device)
    unbatched = {r["path"]: r["steps_per_s"] for r in main_rows}

    def shots(n=nb):
        p0, p1, vp2, damp, dt = acoustic.make_fields(MAIN_SHAPE, pml_width=PML_WIDTH,
                                                     batch=n, device=device)
        vp2.interior = vp2s[:n]
        acoustic.inject_source(p1, 0, pos=pos[:n])
        return [p0, p1, vp2, damp], dt

    def one_shot(fields, b):
        out = [st.grid(st.f32, MAIN_SHAPE, acoustic.ORDER, data=f.data[b].clone())
               for f in fields]
        return out

    def acoustic_run(backend, fields, dt, positions):
        def between(t, grids):
            acoustic.inject_source(grids["p1"], t, pos=positions)
        return st.launch(backend=backend, fuse_steps=ACOUSTIC_FUSE)(
            acoustic.acoustic_target_fused)(*fields, dt, STEPS, between=between).value

    rows = []
    ref_fields, dt = shots()
    t0 = time.perf_counter()
    acoustic_run(st.torch(), ref_fields, dt, pos)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    ref = {"p0": ref_fields[0].data, "p1": ref_fields[1].data}
    del ref_fields
    torch.cuda.empty_cache()
    for kname, (template, k) in KERNELS.items():
        key = f"{kname}[acoustic_iso]"
        be = st.hopper(template=template, time_block=k)
        fields, dt = shots()
        init = [f.copy() for f in fields]
        reset_counts()
        res = acoustic_run(be, fields, dt, pos)
        seen = counts()
        if seen[kname] != STEPS // k or sum(seen.values()) != STEPS // k:
            fail(f"batched {key}: launch counts {seen}, expected {STEPS // k} of "
                 f"{kname} (the unbatched path's) and no other")
        entries[key]["batched_launches"] = seen[kname]
        worst = 0.0
        for b in range(nb):
            got = {"p0": fields[0].data[b], "p1": fields[1].data[b]}
            scale = max(float(r[b].abs().max()) for r in ref.values())
            diff = max(float((got[g] - ref[g][b]).abs().max()) for g in got)
            if not all(bool(torch.isfinite(t).all()) for t in got.values()):
                fail(f"batched {key}: shot {b} not finite")
            if diff > END_TO_END_RTOL * max(scale, 1e-3):
                fail(f"batched {key}: shot {b} max |hopper - torch| = {diff} "
                     f"(field max {scale}, limit {END_TO_END_RTOL} of it)")
            worst = max(worst, diff / max(scale, 1e-3))
            one = one_shot(init, b)
            acoustic_run(be, one, dt, pos[b])
            for g, f in zip(("p0", "p1"), one[:2]):
                if not torch.equal(f.data, got[g]):
                    fail(f"batched {key}: shot {b} grid {g} differs from its "
                         f"unbatched run (max {float((f.data - got[g]).abs().max())})")
            del one
        steps_s = STEPS / res.seconds
        single = unbatched[key]
        row = {"path": f"batched {key}", "batch": nb, "template": template,
               "time_block": k, "steps": STEPS, "fuse_steps": res.fuse_steps,
               "seconds": res.seconds, "steps_per_s": steps_s,
               "scenario_steps_per_s": nb * steps_s,
               "unbatched_steps_per_s": single,
               "scenario_steps_over_unbatched": nb * steps_s / single,
               "launches": seen[kname], "bit_equal_to_serial": True,
               "max_rel_diff_vs_torch": worst, "torch_seconds": ref_s}
        rows.append(row)
        say(f"batched {key} B={nb}: {STEPS} steps in {res.seconds:.3f} s = "
            f"{steps_s:.1f} steps/s, {nb * steps_s:.1f} scenario-steps/s "
            f"({row['scenario_steps_over_unbatched']:.3f} x the unbatched "
            f"{single:.1f} steps/s); {seen[kname]} launches; every shot equal to "
            f"its unbatched run bit for bit, within {worst:.3g} of its max of "
            f"st.torch() (batched, {ref_s:.1f} s)")
        del fields, init
        torch.cuda.empty_cache()
    del ref
    torch.cuda.empty_cache()

    # star3d4r, B = 2, under K2
    k = suite.get_kernel("star3d4r")
    gen = torch.Generator(device=device).manual_seed(0)
    init = torch.randn((STAR_SHOTS,) + MAIN_SHAPE, generator=gen, device=device)

    def star_grids():
        u = st.grid(st.f32, MAIN_SHAPE, 4, batch=STAR_SHOTS, device=device)
        u.interior = init
        return {"u": u, "v": st.grid(st.f32, MAIN_SHAPE, 4, batch=STAR_SHOTS,
                                     device=device)}

    def star_run(backend, grids):
        return st.launch(backend=backend)(lambda u, v: st.timeloop(
            STEPS, swap=("v", "u"))(k)(u, v))(grids["u"], grids["v"]).value

    ref = star_grids()
    star_run(st.torch(), ref)
    key = "stream_step[star3d4r]"
    grids = star_grids()
    first = {g: x.copy() for g, x in grids.items()}
    reset_counts()
    res = star_run(st.hopper(template="shift"), grids)
    seen = counts()
    if seen["stream_step"] != STEPS or sum(seen.values()) != STEPS:
        fail(f"batched {key}: launch counts {seen}")
    entries[key]["batched_launches"] = seen["stream_step"]
    worst = 0.0
    for b in range(STAR_SHOTS):
        scale = max(float(ref[g].data[b].abs().max()) for g in ref)
        diff = max(float((grids[g].data[b] - ref[g].data[b]).abs().max()) for g in ref)
        if diff > END_TO_END_RTOL * max(scale, 1e-3):
            fail(f"batched {key}: scenario {b} max |hopper - torch| = {diff}")
        worst = max(worst, diff / max(scale, 1e-3))
        one = {g: st.grid(st.f32, MAIN_SHAPE, 4, data=x.data[b].clone())
               for g, x in first.items()}
        star_run(st.hopper(template="shift"), one)
        if not all(torch.equal(one[g].data, grids[g].data[b]) for g in one):
            fail(f"batched {key}: scenario {b} differs from its unbatched run")
    steps_s = STEPS / res.seconds
    single = unbatched[key]
    rows.append({"path": f"batched {key}", "batch": STAR_SHOTS, "template": "shift",
                 "time_block": 1, "steps": STEPS, "seconds": res.seconds,
                 "steps_per_s": steps_s, "scenario_steps_per_s": STAR_SHOTS * steps_s,
                 "unbatched_steps_per_s": single,
                 "scenario_steps_over_unbatched": STAR_SHOTS * steps_s / single,
                 "launches": seen["stream_step"], "bit_equal_to_serial": True,
                 "max_rel_diff_vs_torch": worst})
    say(f"batched {key} B={STAR_SHOTS}: {steps_s:.1f} steps/s, "
        f"{STAR_SHOTS * steps_s:.1f} scenario-steps/s ({STAR_SHOTS * steps_s / single:.3f}"
        f" x the unbatched {single:.1f}); equal to the serial runs; within {worst:.3g} "
        f"of st.torch()")
    del ref, grids, first
    torch.cuda.empty_cache()

    # (B, NS) scalars at the small shapes: one launch against the plain
    # version, a dt a scenario
    w = mods["acoustic_workload"]
    dts = torch.tensor([0.2, 0.25, 0.3])
    scal_rows = []
    for shape in SMALL_SHAPES:
        for kname, (template, _) in KERNELS.items():
            for kb in fused_depths(kname, shape):
                plan = w.plan(codegen, shape, template, kb)
                arrays = {g: torch.stack([w.arrays(torch, shape, seed=10 + b)[g]
                                          for b in range(len(dts))])
                          for g in w.kernel.ir.grid_params}
                sc = plan.scenario_scalars({"dt": dts}, len(dts), device)
                kern, plain = wrappers[kname]
                reset_counts()
                got, want, _, _ = one_launch(torch, kname, kern, plain, plan, arrays, sc)
                if counts()[kname] != 1:
                    fail(f"{kname} (B, NS) scalars: {counts()[kname]} launches, not one")
                err = check_out(torch, f"{kname} k={kb} (B, NS) scalars at {shape}",
                                {g: got[g] for g in plan.step_out_grids},
                                {g: want[g] for g in plan.step_out_grids}, rel_tol)
                scal_rows.append({"kernel": kname, "time_block": kb, "shape": list(shape),
                                  "batch": len(dts), "max_abs_err": err})
                say(f"kernel {kname} k={kb} {shape} B={len(dts)}, a dt a scenario: "
                    f"one launch, max abs err {err:.3g} vs plain")
    return {"rows": rows, "scalars": scal_rows}


def adjoint_phase(torch, mods, counters, device="cuda"):
    """Phase 11 (b): the gradient at 512³ f32.  Acoustic ISO, one shot,
    100 steps, the source in ``between``: the loss is the sum of squares
    of the final ``p1`` minus the ``p1`` "observed" with the same
    propagator on the true model (the background with a slow blob), at the
    background model.  Its gradient with respect to p0, p1, vp² and dt
    through ``st.differentiable_timeloop`` under ``st.hopper(template=
    "gmem")`` (K1) with the default schedule, against the same adjoint
    under ``st.torch()`` (``ADJOINT_TOL`` of each gradient's max), and the
    vp² gradient along the blob against a central difference of the loss
    (``ADJOINT_FD_TOL``).  Returns the phase's record."""
    st, acoustic, adjoint = mods["st"], mods["acoustic"], mods["adjoint"]
    reset_counts, counts = counters
    pos, vp2s, blob = shot_models(torch, acoustic, 1, device)
    p0, p1, vp2, damp, dt = acoustic.make_fields(MAIN_SHAPE, pml_width=PML_WIDTH,
                                                 device=device)
    acoustic.inject_source(p1, 0, pos=pos[0])
    o = acoustic.ORDER
    inner = tuple(slice(o, o + n) for n in MAIN_SHAPE)
    true_vp2 = vp2.data.clone()
    true_vp2[inner] = vp2s[0]
    direction = torch.zeros_like(vp2.data)
    direction[inner] = blob

    def between(t, grids):
        acoustic.inject_source(grids["p1"], t, pos=pos[0])

    def run_for(backend):
        return st.differentiable_timeloop(
            acoustic.acoustic_iso_kernel, p0, p1, vp2, damp, dt, steps=STEPS,
            swap=("p0", "p1"), between=between, backend=backend)

    fn = run_for(st.hopper(template="gmem"))
    sched = fn.schedule
    with torch.no_grad():
        observed = fn({**fn.arrays, "vp2": true_vp2})["p1"]

    def loss_of(out):
        return ((out["p1"] - observed).double() ** 2).sum()

    def gradient(fn, label):
        arrays = {n: (a.detach().clone().requires_grad_() if n != "damp" else a)
                  for n, a in fn.arrays.items()}
        d = torch.tensor(float(dt), device=device, requires_grad=True)
        adjoint.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loss = loss_of(fn(arrays, {"dt": d}))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        row = {"backend": label, "loss": float(loss.detach()), "forward_s": t1 - t0,
               "backward_s": t2 - t1, "seconds": dict(adjoint.SECONDS),
               "checkpoint_stats": dict(adjoint.CHECKPOINT_STATS),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts()}
        grads = {n: arrays[n].grad for n in ("p0", "p1", "vp2")}
        grads["dt"] = d.grad
        for n, g in grads.items():
            if g is None or not bool(torch.isfinite(g).all()):
                fail(f"adjoint {label}: gradient of {n} missing or not finite")
        return row, grads

    try:
        hrow, hgrads = gradient(fn, "hopper gmem")
    except torch.cuda.OutOfMemoryError as e:
        fail(f"adjoint at {MAIN_SHAPE}: the peak does not fit on the card ({e})")
    want_stats = {"checkpoints": sched["checkpoints"], "replayed_windows": 0,
                  "vjp_windows": len(sched["windows"])}
    n_ckpts = -(-STEPS // ADJOINT_FUSE)
    if (sched["fuse"], sched["checkpoints"]) != (ADJOINT_FUSE, n_ckpts) \
            or hrow["checkpoint_stats"] != want_stats:
        fail(f"adjoint schedule {sched}, stats {hrow['checkpoint_stats']}, expected "
             f"fuse {ADJOINT_FUSE}, {n_ckpts} checkpoints and {want_stats}")
    # the forward pass and the backward pass's step-by-step replay: one K1
    # launch a step each, and no other kernel
    launches = hrow["launches"]
    if launches["fused_step"] != 2 * STEPS or sum(launches.values()) != 2 * STEPS:
        fail(f"adjoint launch counts {launches}, expected {2 * STEPS} of fused_step "
             f"(forward + replay) and no other")
    say(f"adjoint hopper gmem at {MAIN_SHAPE}, {STEPS} steps, schedule {sched}: "
        f"loss {hrow['loss']:.6g}; forward {hrow['forward_s']:.3f} s, backward "
        f"{hrow['backward_s']:.3f} s (replay {hrow['seconds']['replay']:.3f}, "
        f"recompute {hrow['seconds']['recompute']:.3f}, vjp "
        f"{hrow['seconds']['vjp']:.3f}); {launches['fused_step']} K1 launches; "
        f"peak {hrow['peak_gb']:.2f} GB")
    del fn
    torch.cuda.empty_cache()

    trow, tgrads = gradient(run_for(st.torch()), "torch")
    if sum(trow["launches"].values()):
        fail(f"adjoint st.torch(): kernel launches {trow['launches']}")
    errs = {}
    for n, want in tgrads.items():
        scale = float(want.abs().max())
        err = float((hgrads[n] - want).abs().max())
        if not err <= ADJOINT_TOL * scale:
            fail(f"adjoint gradient of {n}: max |hopper - torch| = {err} > "
                 f"{ADJOINT_TOL} x {scale}")
        errs[n] = {"max_abs_diff": err, "max": scale}
    say(f"adjoint st.torch(): forward {trow['forward_s']:.3f} s, backward "
        f"{trow['backward_s']:.3f} s; gradients vs hopper: " + ", ".join(
            f"{n} {e['max_abs_diff']:.3g} of max {e['max']:.3g}" for n, e in errs.items()))
    del tgrads
    torch.cuda.empty_cache()

    # the vp² gradient along the blob against a central difference
    fn = run_for(st.hopper(template="gmem"))
    with torch.no_grad():
        hi = float(loss_of(fn({**fn.arrays, "vp2": vp2.data + ADJOINT_EPS * direction})))
        lo = float(loss_of(fn({**fn.arrays, "vp2": vp2.data - ADJOINT_EPS * direction})))
    fd = (hi - lo) / (2 * ADJOINT_EPS)
    gd = float((hgrads["vp2"].double() * direction.double()).sum())
    rel = abs(fd - gd) / max(abs(gd), 1e-30)
    if not rel <= ADJOINT_FD_TOL:
        fail(f"adjoint: <g, d> = {gd} but the central difference (eps "
             f"{ADJOINT_EPS}) is {fd}: relative error {rel} > {ADJOINT_FD_TOL}")
    say(f"adjoint: <g_vp2, blob> = {gd:.6g}, central difference (eps {ADJOINT_EPS}) "
        f"{fd:.6g}, relative error {rel:.3g}; gradient / forward time "
        f"{hrow['backward_s'] / hrow['forward_s']:.1f}")
    return {"schedule": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in sched.items()},
            "hopper": hrow, "torch": trow, "grad_vs_torch": errs,
            "directional": {"eps": ADJOINT_EPS, "fd": fd, "g_dot_d": gd,
                            "relative_error": rel},
            "backward_over_forward": hrow["backward_s"] / hrow["forward_s"]}


def units_run(n: int, every: int, fails) -> list:
    """The units ``run_with_restarts`` executes, in order, for ``n`` units
    saved every ``every`` (and after the last) with a failure injected
    before each unit of ``fails`` (once each): a failure resumes at the
    last save, or from the start before the first."""
    done, saved, start, fails = [], 0, 0, set(fails)
    while True:
        for s in range(start, n):
            if s in fails:
                fails.discard(s)
                start = saved
                break
            done.append(s)
            if (s + 1) % every == 0 or s + 1 == n:
                saved = s + 1
        else:
            return done


def ckpt_stats(ckpt) -> dict:
    """Per save and per restore, from ``checkpoint.STATS``: bytes and
    seconds (a save: device to host, then the files; a restore: the files,
    then the tensors on the card)."""
    s = dict(ckpt.STATS)
    n, r = max(s["saves"], 1), max(s["restores"], 1)
    return {"saves": s["saves"], "bytes_a_save": s["save_bytes"] / n,
            "snapshot_s_a_save": s["snapshot_s"] / n, "write_s_a_save": s["write_s"] / n,
            "restores": s["restores"], "bytes_a_restore": s["restore_bytes"] / r,
            "read_s_a_restore": s["read_s"] / r, "place_s_a_restore": s["place_s"] / r}


def say_ckpt(label: str, c: dict) -> None:
    say(f"{label}: {c['saves']} saves of {c['bytes_a_save'] / 1e9:.3f} GB, each "
        f"{c['snapshot_s_a_save']:.3f} s device to host + {c['write_s_a_save']:.3f} s "
        f"written; {c['restores']} restores of {c['bytes_a_restore'] / 1e9:.3f} GB, each "
        f"{c['read_s_a_restore']:.3f} s read + {c['place_s_a_restore']:.3f} s to the card")


def resilience_phase(torch, mods, counters, backend, device="cuda"):
    """Phase 12: resilience on the card.  (a) Acoustic ISO at 512³ f32, PML
    10, 100 steps in windows of 10 with the source in ``between``, on the
    tuned acoustic build ``backend``, through ``timeloop.run_resilient``
    (a save every ``RESILIENCE_CKPT_EVERY`` windows, failures injected
    before windows ``RESILIENCE_FAILS``): bit for bit an uninterrupted
    ``engine.run``, one restart a failure, the launches of the windows run
    (replays included); then a fresh run of 50 steps and another of 100
    on the same directory (no hook: a run ending at 50 does not inject at
    50), bit for bit the uninterrupted run, the second run launching
    only the last 5 windows.  (b) The gradient at ``GRAD_SHAPE``
    (``run_resilient(loss=)``, a failure in a forward unit and one in a
    backward segment): value and gradients bit for bit the uninterrupted
    ``differentiable_run`` under the same engine.  (c) ``launch.train``'s
    step on ``configs.tiny(recurrentgemma-9b)`` at the CLI's smoke size
    through ``run_with_restarts`` with a failure at step
    ``TRAIN_RESTART_FAIL``: losses and state equal to the uninterrupted
    run (bit for bit when two uninterrupted runs agree bit for bit), and
    the CLI itself with ``--ckpt-dir`` on the card.  Checkpoints go to
    directories under ``CKPT_ROOT``, removed afterwards.  Returns the
    phase's record."""
    import dataclasses
    import tempfile
    st, acoustic, tl, adjoint = mods["st"], mods["acoustic"], mods["timeloop"], mods["adjoint"]
    ckpt, ft = mods["checkpoint"], mods["fault_tolerance"]
    reset_counts, counts = counters
    k = acoustic.acoustic_iso_kernel
    swap = ("p0", "p1")
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    record = {}

    def fields_at(shape):
        p0, p1, vp2, damp, dt = acoustic.make_fields(shape, pml_width=PML_WIDTH,
                                                     device=device)
        acoustic.inject_source(p1, 0)
        arrays = {"p0": p0.data, "p1": p1.data, "vp2": vp2.data, "damp": damp.data}
        return arrays, float(dt), {n: (acoustic.ORDER,) * 3 for n in arrays}

    def between_for(shape):
        # acoustic.inject_source on the engine's arrays (in place; out of place where
        # autograd records the hook) on the engine's arrays
        def between(t, arrays):
            p = st.grid(st.f32, shape, acoustic.ORDER, data=arrays["p1"])
            acoustic.inject_source(p, t)
            return {**arrays, "p1": p.data}
        return between

    def launches_of(be, halos, shape, sizes):
        """{wrapper: launches} of windows of ``sizes`` steps under ``be``."""
        plan, plan1 = tl.hopper_plans(k.ir, halos, shape, be, swap)
        want = {}
        for kw in sizes:
            blocked, single, _ = tl.launch_steps(kw, kw, plan.time_block)
            for name, n in ((KIND_WRAPPER[plan.kind], blocked // plan.time_block),
                            (KIND_WRAPPER[plan1.kind], single)):
                if n:
                    want[name] = want.get(name, 0) + n
        return want

    def check_launches(label, want):
        seen = {g: c for g, c in counts().items() if c}
        if seen != want:
            fail(f"{label}: launch counts {seen}, expected {want}")
        return seen

    def check_restarts(label, inj, restarts, n):
        if len(restarts) != n or len(inj.fired) != n \
                or not all("injected node failure" in r for r in restarts):
            fail(f"{label}: restarts {restarts}, injected {inj.fired}: every restart "
                 f"must be one of the {n} injected failures")

    def tmpdir():
        return tempfile.mkdtemp(dir=CKPT_ROOT)

    # (a) the forward run at 512³
    arrays, dt, halos = fields_at(MAIN_SHAPE)
    scal = {"dt": dt}
    between = between_for(MAIN_SHAPE)
    n_win = STEPS // ACOUSTIC_FUSE

    def engine():
        return tl.TimeloopEngine(k.ir, halos, MAIN_SHAPE, backend, swap=swap)

    warm = {n: a.clone() for n, a in arrays.items()}
    engine().run(warm, scal, ACOUSTIC_FUSE, ACOUSTIC_FUSE)      # loads the build
    del warm
    ref = {n: a.clone() for n, a in arrays.items()}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = engine().run(ref, scal, STEPS, ACOUSTIC_FUSE, between)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    check_launches("resilience uninterrupted",
                   launches_of(backend, halos, MAIN_SHAPE, [ACOUSTIC_FUSE] * n_win))
    d = tmpdir()
    try:
        ckpt.reset_stats()
        inj, restarts = ft.FailureInjector(RESILIENCE_FAILS), []
        reset_counts()
        t0 = time.perf_counter()
        got = tl.run_resilient(engine(), arrays, scal, STEPS, ACOUSTIC_FUSE, between,
                               ckpt_dir=d, ckpt_every=RESILIENCE_CKPT_EVERY, injector=inj,
                               on_restart=lambda n, e: restarts.append(repr(e)))
        torch.cuda.synchronize()
        res_s = time.perf_counter() - t0
        ran = units_run(n_win, RESILIENCE_CKPT_EVERY, RESILIENCE_FAILS)
        seen = check_launches("resilient run", launches_of(
            backend, halos, MAIN_SHAPE, [ACOUSTIC_FUSE] * len(ran)))
        check_restarts("resilient run", inj, restarts, len(RESILIENCE_FAILS))
        for n in ref:
            if not torch.equal(got[n], ref[n]):
                fail(f"resilient run at {MAIN_SHAPE}: grid {n} differs from the "
                     f"uninterrupted run (max {float((got[n] - ref[n]).abs().max())})")
        stats = ckpt_stats(ckpt)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del got
    record["forward"] = {"shape": list(MAIN_SHAPE), "backend": describe(backend, ACOUSTIC_FUSE),
                         "uninterrupted_s": plain_s, "resilient_s": res_s,
                         "restarts": len(restarts), "windows_run": len(ran),
                         "windows_replayed": len(ran) - n_win, "launches": seen,
                         "checkpoints": stats, "bit_equal": True}
    say(f"resilience {MAIN_SHAPE} on {describe(backend, ACOUSTIC_FUSE)}: uninterrupted "
        f"{plain_s:.3f} s, resilient {res_s:.3f} s with {len(restarts)} restarts "
        f"(failures before windows {list(RESILIENCE_FAILS)}; {len(ran)} windows run, "
        f"{len(ran) - n_win} replayed; launches {seen}); bit for bit the uninterrupted run")
    say_ckpt("resilience checkpoints", stats)

    # a fresh run resumes a directory another one left
    d = tmpdir()
    try:
        plain = engine().run({n: a.clone() for n, a in arrays.items()}, scal, STEPS,
                             ACOUSTIC_FUSE)
        tl.run_resilient(engine(), arrays, scal, STEPS // 2, ACOUSTIC_FUSE, ckpt_dir=d,
                         ckpt_every=RESILIENCE_CKPT_EVERY)
        first = ckpt.steps(d)
        reset_counts()
        got = tl.run_resilient(engine(), arrays, scal, STEPS, ACOUSTIC_FUSE, ckpt_dir=d,
                               ckpt_every=RESILIENCE_CKPT_EVERY)
        torch.cuda.synchronize()
        check_launches("resumed run", launches_of(backend, halos, MAIN_SHAPE,
                                                  [ACOUSTIC_FUSE] * (n_win // 2)))
        for n in plain:
            if not torch.equal(got[n], plain[n]):
                fail(f"resumed run: grid {n} differs from the uninterrupted run")
        record["resume"] = {"first_run_saves": first, "second_run_saves": ckpt.steps(d),
                            "bit_equal": True}
        say(f"resilience resume: a run of {STEPS // 2} steps saved windows {first}; a "
            f"fresh one of {STEPS} steps resumed there ({n_win // 2} windows launched), "
            f"bit for bit the uninterrupted run")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    del arrays, ref, plain, got
    torch.cuda.empty_cache()

    # (b) the gradient at GRAD_SHAPE
    arrays, dt, halos = fields_at(GRAD_SHAPE)
    between = between_for(GRAD_SHAPE)
    be = st.hopper(template="gmem")
    eng = tl.TimeloopEngine(k.ir, halos, GRAD_SHAPE, be, swap=swap, differentiable=True)

    def loss(out):
        return (out["p1"].double() ** 2).sum()

    fn = adjoint.differentiable_run(eng, STEPS, ACOUSTIC_FUSE, between)
    sched = fn.schedule
    sizes, stride, n_ckpts = sched["windows"], sched["stride"], sched["checkpoints"]
    W = len(sizes)
    x = {n: a.detach().clone().requires_grad_() for n, a in arrays.items()}
    d_t = torch.tensor(dt, device=device, requires_grad=True)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    value = loss(fn(x, {"dt": d_t}))
    value.backward()
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    check_launches("gradient uninterrupted",
                   launches_of(be, halos, GRAD_SHAPE, [1] * (2 * STEPS)))
    want = {n: x[n].grad for n in x}
    want_dt = d_t.grad
    del x
    # the steps a unit launches: a forward window; the seed none; a backward
    # segment replays its windows but the last, then each a step at a time
    unit_steps = list(sizes) + [0] + [
        sum(sizes[seg * stride:min(seg * stride + stride, W) - 1])
        + sum(sizes[seg * stride:min(seg * stride + stride, W)])
        for seg in reversed(range(n_ckpts))]
    d = tmpdir()
    try:
        ckpt.reset_stats()
        inj, restarts = ft.FailureInjector(GRAD_FAILS), []
        reset_counts()
        t0 = time.perf_counter()
        got = tl.run_resilient(eng, arrays, {"dt": dt}, STEPS, ACOUSTIC_FUSE, between,
                               ckpt_dir=d, ckpt_every=GRAD_CKPT_EVERY, injector=inj, loss=loss,
                               on_restart=lambda n, e: restarts.append(repr(e)))
        torch.cuda.synchronize()
        res_s = time.perf_counter() - t0
        ran = units_run(W + 1 + n_ckpts, GRAD_CKPT_EVERY, GRAD_FAILS)
        seen = check_launches("resilient gradient", launches_of(
            be, halos, GRAD_SHAPE, [1] * sum(unit_steps[u] for u in ran)))
        check_restarts("resilient gradient", inj, restarts, len(GRAD_FAILS))
        stats = ckpt_stats(ckpt)
        if stats["saves"] > 4:
            fail(f"resilient gradient: {stats['saves']} saves, more than 4")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if float(got["value"]) != float(value.detach()):
        fail(f"resilient gradient: value {float(got['value'])} != {float(value.detach())}")
    for n, w in want.items():
        if not torch.equal(got["grad_arrays"][n], w):
            fail(f"resilient gradient of {n} differs from the uninterrupted one (max "
                 f"{float((got['grad_arrays'][n] - w).abs().max())})")
    if not torch.equal(got["grad_scalars"]["dt"], want_dt):
        fail(f"resilient gradient of dt {got['grad_scalars']['dt']} != {want_dt}")
    record["gradient"] = {"shape": list(GRAD_SHAPE), "schedule": {
        "windows": W, "checkpoints": n_ckpts, "units": W + 1 + n_ckpts},
        "uninterrupted_s": ref_s, "resilient_s": res_s, "restarts": len(restarts),
        "units_run": len(ran), "launches": seen, "checkpoints": stats, "bit_equal": True}
    say(f"resilient gradient at {GRAD_SHAPE} ({W} windows, {n_ckpts} checkpoints, "
        f"{W + 1 + n_ckpts} units, a save every {GRAD_CKPT_EVERY}): uninterrupted "
        f"{ref_s:.3f} s, resilient {res_s:.3f} s with {len(restarts)} restarts (failures "
        f"before units {list(GRAD_FAILS)}; {len(ran)} units run; launches {seen}); value "
        f"and every gradient bit for bit the uninterrupted adjoint's")
    say_ckpt("resilient gradient checkpoints", stats)
    del arrays, want, got, fn, eng
    torch.cuda.empty_cache()

    # (c) the training restart at the CLI's smoke size
    configs, train_loop, optimizer, data, shapes, train_cli = (
        mods["configs"], mods["train_loop"], mods["optimizer"], mods["data"],
        mods["shapes"], mods["train_cli"])
    cfg = configs.tiny(configs.get(SERVE_ARCH))
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=TRAIN_CLI_SEQ,
                                global_batch=TRAIN_CLI_BATCH)
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(
        lr=TRAIN_CLI_LR, warmup_steps=TRAIN_CLI_WARMUP, total_steps=TRAIN_RESTART_STEPS))
    step = train_loop.make_train_step(cfg, tc)

    def init_fn():
        return train_loop.init_state(cfg, device=device, seed=0)

    def stepper(losses):
        def one(state, i):
            state, metrics = step(state, batch_fn(i))
            losses[i] = float(metrics["loss"])
            return state
        return one

    def uninterrupted():
        losses, state = {}, init_fn()
        one = stepper(losses)
        reset_counts()
        for i in range(TRAIN_RESTART_STEPS):
            state = one(state, i)
        return losses, state, counts()["causal_conv1d"]

    def leaves(state):
        return [t for t in ckpt.flatten(state)[0] if isinstance(t, torch.Tensor)]

    def spread(a, b):
        la, sa = a
        lb, sb = b
        return max([abs(la[i] - lb[i]) for i in la]
                   + [float((x - y).abs().max()) for x, y in zip(leaves(sa), leaves(sb))])

    ref_a, ref_b = uninterrupted(), uninterrupted()
    k6_a_step = ref_a[2] / TRAIN_RESTART_STEPS
    noise = spread(ref_a[:2], ref_b[:2])
    d = tmpdir()
    try:
        ckpt.reset_stats()
        losses, restarts = {}, []
        inj = ft.FailureInjector([TRAIN_RESTART_FAIL])
        reset_counts()
        t0 = time.perf_counter()
        state = ft.run_with_restarts(
            init_fn=init_fn, step_fn=stepper(losses), n_steps=TRAIN_RESTART_STEPS,
            ckpt_dir=d, ckpt_every=TRAIN_RESTART_EVERY, injector=inj,
            on_restart=lambda n, e: restarts.append(repr(e)))
        torch.cuda.synchronize()
        restart_s = time.perf_counter() - t0
        k6 = counts()["causal_conv1d"]
        ran = units_run(TRAIN_RESTART_STEPS, TRAIN_RESTART_EVERY, [TRAIN_RESTART_FAIL])
        if k6 != k6_a_step * len(ran) or not k6:
            fail(f"training restart: {k6} K6 launches, expected {k6_a_step} a step x "
                 f"{len(ran)} steps run")
        check_restarts("training restart", inj, restarts, 1)
        diff = spread((losses, state), ref_a[:2])
        if not diff <= noise:
            fail(f"training restart: losses and state differ from the uninterrupted run "
                 f"by {diff}, more than two uninterrupted runs differ ({noise})")
        stats = ckpt_stats(ckpt)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    d = tmpdir()
    try:
        cli = train_cli.main(["--ckpt-dir", d, "--steps", "2", "--ckpt-every", "1"])
        if len(cli) != 2 or not all(math.isfinite(v) for v in cli) or ckpt.steps(d) != [1, 2]:
            fail(f"launch.train --ckpt-dir on the card: losses {cli}, saves {ckpt.steps(d)}")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    record["training"] = {"config": cfg.name, "steps": TRAIN_RESTART_STEPS,
                          "restart_s": restart_s, "restarts": len(restarts),
                          "steps_run": len(ran), "k6_launches": k6,
                          "max_diff_vs_uninterrupted": diff,
                          "uninterrupted_spread": noise, "checkpoints": stats,
                          "cli_losses": cli}
    say(f"training restart ({cfg.name}, tiny, batch {TRAIN_CLI_BATCH} x seq "
        f"{TRAIN_CLI_SEQ}): {TRAIN_RESTART_STEPS} steps, a failure before step "
        f"{TRAIN_RESTART_FAIL}, {len(restarts)} restart, {len(ran)} steps run in "
        f"{restart_s:.3f} s, {k6} K6 launches; losses and state within {diff:.3g} of the "
        f"uninterrupted run (two uninterrupted runs: {noise:.3g}); launch.train "
        f"--ckpt-dir on the card: losses {[round(v, 4) for v in cli]}")
    say_ckpt("training checkpoints", stats)
    return record


def sim_requests(np):
    """Phase 13's requests: (interior shape, steps) drawn from ``SIM_SEED``,
    each extent in ``SIM_SHAPE_RANGE`` (one 256³ bucket), steps in
    ``SIM_STEP_RANGE``; request ``SIM_ZERO`` asks for 0 steps."""
    rng = np.random.default_rng(SIM_SEED)
    lo, hi = SIM_SHAPE_RANGE
    shapes = [tuple(int(x) for x in rng.integers(lo, hi + 1, size=3))
              for _ in range(SIM_REQUESTS)]
    steps = [int(x) for x in rng.integers(SIM_STEP_RANGE[0], SIM_STEP_RANGE[1] + 1,
                                          size=SIM_REQUESTS)]
    steps[SIM_ZERO] = 0
    return list(zip(shapes, steps))


def stencil_serve_phase(torch, np, mods, counters, device="cuda"):
    """Phase 13: ``SimServer`` on the card.  ``SIM_REQUESTS`` star3d4r
    requests (``sim_requests``; payloads drawn with numpy), ``batch_cap``
    ``SIM_CAP``, fuse window ``SIM_FUSE``: two waves of the masked batched
    ``st.torch()`` window; each result within ``rtol=SIM_RTOL,
    atol=SIM_ATOL`` of its own serial unbatched ``st.torch()`` run at its
    true shape on the card, the first also within ``END_TO_END_RTOL`` of
    its max of the same run under K2 (``st.hopper(template="shift")``);
    requests/s, seconds a wave, latency p50/max, peak device memory a wave.
    Then a server with ``autotune_cache=`` (a temporary directory), cold
    and warm (the in-process caches and cost models dropped), on the first
    wave's requests: the cold one measures candidates, the warm one none,
    with the same fuse window and the same results.  Returns the phase's
    record."""
    import statistics
    import tempfile
    st, suite, at, cm, serve = (mods["st"], mods["suite"], mods["autotune"],
                                mods["cost_model"], mods["stencil_serve"])
    reset_counts, counts = counters
    k = suite.get_kernel("star3d4r")
    reqs = sim_requests(np)
    rng = np.random.default_rng(SIM_SEED + 1)
    payloads = [{"u": rng.standard_normal(s, dtype=np.float32)} for s, _ in reqs]
    bucket = at.shape_bucket((SIM_SHAPE_RANGE[1],) * 3)
    keys = {serve.bucket_key("star3d4r", s) for s, _ in reqs}
    if keys != {("star3d4r", bucket, "float32")}:
        fail(f"stencil serving: buckets {keys}, expected one of {bucket}")

    def serial(shape, steps, payload, backend):
        gs = {g: st.grid(st.f32, shape, k.info.order, device=device) for g in ("u", "v")}
        gs["u"].interior = torch.from_numpy(payload["u"]).to(device)
        if steps:
            st.launch(backend=backend)(lambda: st.timeloop(steps, swap=("v", "u"))(k)(
                gs["u"], gs["v"]))()
        return {g: gs[g].interior for g in gs}

    def check(label, result, want):
        worst = 0.0
        for g, w in want.items():
            got = torch.from_numpy(result[g]).to(device)
            err = (got - w).abs()
            if bool((err > SIM_ATOL + SIM_RTOL * w.abs()).any()):
                fail(f"stencil serving {label} grid {g}: max |served - serial| "
                     f"{float(err.max())} beyond rtol {SIM_RTOL}, atol {SIM_ATOL}")
            worst = max(worst, float(err.max()))
        return worst

    srv = serve.SimServer(batch_cap=SIM_CAP, fuse_window=SIM_FUSE, device=device)
    uids = [srv.submit("star3d4r", s, n, p) for (s, n), p in zip(reqs, payloads)]
    done, wave_s, peaks = {}, [], []
    reset_counts()
    t0 = time.perf_counter()
    while srv.pending():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tw = time.perf_counter()
        for r in srv.step(force=True):
            done[r.uid] = r
        torch.cuda.synchronize()
        wave_s.append(time.perf_counter() - tw)
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
    total_s = time.perf_counter() - t0
    if sum(counts().values()) or srv.waves_run != 2:
        fail(f"stencil serving: {srv.waves_run} waves, launches {counts()} (the masked "
             f"windows run st.torch(): no kernel)")
    lat = sorted(done[u].done_at - done[u].submitted_at for u in uids)
    (eng, fuse), = srv._engines.values()
    worst, refs = 0.0, {}
    for i, ((shape, steps), p) in enumerate(zip(reqs, payloads)):
        want = serial(shape, steps, p, st.torch())
        worst = max(worst, check(f"request {i} {shape} x {steps}", done[uids[i]].result, want))
        if i < SIM_CAP:
            refs[i] = want
    # the first request again under K2, at its own shape
    shape, steps = reqs[0]
    reset_counts()
    k2 = serial(shape, steps, payloads[0], st.hopper(template="shift"))
    if {g: c for g, c in counts().items() if c} != {"stream_step": steps}:
        fail(f"stencil serving K2 check: launches {counts()}, expected {steps} of stream_step")
    scale = max(float(w.abs().max()) for w in k2.values())
    k2_diff = max(float((torch.from_numpy(done[uids[0]].result[g]).to(device) - k2[g])
                        .abs().max()) for g in k2)
    if not k2_diff <= END_TO_END_RTOL * scale:
        fail(f"stencil serving: request 0 differs from its K2 run by {k2_diff} (field max "
             f"{scale}, limit {END_TO_END_RTOL} of it)")
    record = {"requests": len(reqs), "bucket": list(bucket), "waves": srv.waves_run,
              "fuse": fuse, "seconds": total_s, "requests_per_s": len(reqs) / total_s,
              "wave_s": wave_s, "latency_p50_s": statistics.median(lat),
              "latency_max_s": lat[-1], "peak_gb_a_wave": peaks,
              "max_abs_diff_vs_serial": worst, "k2_max_abs_diff": k2_diff,
              "k2_field_max": scale}
    say(f"stencil serving star3d4r: {len(reqs)} requests (shapes {SIM_SHAPE_RANGE[0]}-"
        f"{SIM_SHAPE_RANGE[1]} an axis, steps {SIM_STEP_RANGE[0]}-{SIM_STEP_RANGE[1]}, one "
        f"of 0) in {srv.waves_run} waves of {SIM_CAP} at {bucket}, fuse {fuse}: "
        f"{total_s:.3f} s = {len(reqs) / total_s:.3f} requests/s; a wave "
        f"{', '.join(f'{s:.3f}' for s in wave_s)} s, peak "
        f"{', '.join(f'{g:.2f}' for g in peaks)} GB; latency p50 "
        f"{statistics.median(lat):.3f} s, max {lat[-1]:.3f} s; max |served - serial "
        f"st.torch()| {worst:.3g}; request 0 vs K2 {k2_diff:.3g} (field max {scale:.3g})")

    cdir = tempfile.mkdtemp(dir=CKPT_ROOT)
    try:
        tuned = {}
        for label in ("cold", "warm"):
            at.clear_cache()
            cm.reset_default_models()
            at.reset_measure_count()
            srv2 = serve.SimServer(batch_cap=SIM_CAP, fuse_window=SIM_FUSE,
                                   autotune_cache=cdir, device=device)
            ids = [srv2.submit("star3d4r", s, n, p)
                   for (s, n), p in zip(reqs[:SIM_CAP], payloads[:SIM_CAP])]
            t0 = time.perf_counter()
            got = srv2.run_until_drained()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            (_, tfuse), = srv2._engines.values()
            tuned[label] = {"seconds": secs, "fuse": tfuse,
                            "measured": at.MEASURE_COUNT["measured_candidates"],
                            "pruned": at.MEASURE_COUNT["pruned_candidates"],
                            "results": [got[u].result for u in ids]}
            for i in range(SIM_CAP):
                check(f"{label} tuned request {i}", tuned[label]["results"][i], refs[i])
        cold, warm = tuned["cold"], tuned["warm"]
        if not cold["measured"] or warm["measured"] or warm["fuse"] != cold["fuse"]:
            fail(f"stencil serving autotune: cold measured {cold['measured']}, warm "
                 f"{warm['measured']}; fuse {cold['fuse']} then {warm['fuse']}")
        for a, b in zip(cold["results"], warm["results"]):
            if not all(np.array_equal(a[g], b[g]) for g in a):
                fail("stencil serving autotune: the warm server's results differ from "
                     "the cold one's")
    finally:
        shutil.rmtree(cdir, ignore_errors=True)
    record["autotune"] = {lbl: {kk: v for kk, v in t.items() if kk != "results"}
                          for lbl, t in tuned.items()}
    say(f"stencil serving with autotune_cache: cold {cold['seconds']:.3f} s (fuse "
        f"{cold['fuse']}, {cold['measured']} measured, {cold['pruned']} pruned), warm "
        f"{warm['seconds']:.3f} s ({warm['measured']} measured); results equal")
    return record


def _union_us(spans) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, None
    for a, b in sorted(spans):
        if reach is None or a > reach:
            total, reach = total + b - a, b
        elif b > reach:
            total, reach = total + b - reach, b
    return total


def dist_idle(torch, run, trace_path, wall):
    """Device time of ``run()`` from a ``torch.profiler`` trace: ``busy_ms``
    the union of every kernel's and copy's interval on every stream, each
    stream's own busy time, ``compute`` the stream that runs the stencil
    kernels (``map_step``) and ``copy`` the others (the slab copies), and
    ``overlap_ms`` the time the copies ran beside a stencil kernel.  The
    idle share is 1 - busy over ``wall``, the seconds the same ``run()``
    takes unprofiled (ending in a sync)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace_path))
    events = [e for e in json.loads(trace_path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("dur")
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    trace_path.unlink()
    spans, names = {}, {}
    for e in events:
        sid = e.get("args", {}).get("stream")
        spans.setdefault(sid, []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        names.setdefault(sid, []).append(e["name"])
    compute = {sid for sid, ns in names.items() if any("map_step" in n for n in ns)}
    stencil = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
               if "map_step" in e["name"]]
    copies = [iv for sid, ivs in spans.items() if sid not in compute for iv in ivs]
    busy = _union_us([iv for ivs in spans.values() for iv in ivs]) / 1e6
    copy_us, stencil_us = _union_us(copies), _union_us(stencil)
    kinds = {}
    for e in events:
        k = kinds.setdefault(e["name"][:60], [0.0, 0])
        k[0], k[1] = k[0] + float(e["dur"]) / 1e3, k[1] + 1
    return {"wall_s": wall, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall if busy else None,
            "streams": {str(sid): _union_us(ivs) / 1e3 for sid, ivs in spans.items()},
            "compute_streams": sorted(map(str, compute)),
            "copy_ms": copy_us / 1e3, "stencil_ms": stencil_us / 1e3,
            "overlap_ms": (copy_us + stencil_us - _union_us(copies + stencil)) / 1e3,
            "top_kernels": sorted(((n, ms, c) for n, (ms, c) in kinds.items()),
                                  key=lambda t: -t[1])[:6]}


def distributed_phase(torch, np, mods, counters, main_rows, map_rows, entries,
                      device="cuda"):
    """Phase 14: the distributed stencil layer on a ``DIST_MESH`` mesh over
    ("data", "model"), every shard on ``device``, ``grid_axes=DIST_AXES``.
    (a) ``DIST_APPS`` ``st.map`` applications of star3d4r at MAIN_SHAPE
    under ``inner=st.hopper(template=t)`` for gmem and shift, overlap on
    and off: the launches (deep interior and two strips a decomposed axis
    a shard, or one pass a shard), the fields against the same
    applications unsharded; (b) acoustic ISO at MAIN_SHAPE, PML 10, STEPS
    steps in windows of ACOUSTIC_FUSE with the source in ``between``, K4
    gmem, time_steps 1 and 2: the launches ``HaloSpec`` implies, the fields
    against the unsharded gmem run, every pass of the window on the
    shards' tensors against ``map_step_plain``, steps/s, collective bytes
    a window, from a ``torch.profiler`` trace of one window the slab
    copies' device time and how much of it ran beside a K4 pass and the
    device's idle share, the gather/scatter around ``between``; (c)
    star3d4r ``batch=2`` at DIST_SHAPE, each scenario bit for bit its own
    sharded run; (d) the gradient of acoustic at DIST_SHAPE
    (DIST_GRAD_STEPS steps) through ``st.differentiable_timeloop(mesh=)``
    against the unsharded adjoint under gmem (dt's also within twice the
    unsharded K1 and torch adjoints' own difference, a bound that must
    refuse a planted fault: the shards' dt shares not summed); (e)
    ``run_resilient`` on (b)'s depth-2 engine at
    DIST_SHAPE with one failure, bit for bit; (f) ``predict(mesh=)`` of
    (b)'s two depths with the probed link rate against (b)'s times, and
    ``tune(mesh=)`` over them.  Every kernel source of the phase is built
    in one wave first.  Returns the phase's record; sets the K4 entries'
    ``sharded_launches`` ((a) and (b))."""
    (st, suite, acoustic, dist, mesh_mod, tl, adjoint, cm, at, ft,
     build) = (mods[k] for k in ("st", "suite", "acoustic", "distributed", "mesh",
                                 "timeloop", "adjoint", "cost_model", "autotune",
                                 "fault_tolerance", "build"))
    reset_counts, counts = counters
    cuda = device == "cuda"
    mesh = mesh_mod.make_mesh(DIST_MESH, ("data", "model"),
                              devices=[torch.device(device)])
    n_sh = mesh.size
    rec = {"mesh": dict(mesh.shape), "grid_axes": list(DIST_AXES)}

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def gmem(ts=1, overlap=True, template="gmem"):
        return st.distributed(grid_axes=DIST_AXES, overlap=overlap, time_steps=ts,
                              inner=st.hopper(template=template))

    star = suite.get_kernel("star3d4r")
    ak = acoustic.acoustic_iso_kernel
    a_halos = {g: (acoustic.ORDER,) * 3 for g in ak.ir.grid_params}
    s_halos = {g: (star.info.order,) * 3 for g in star.ir.grid_params}
    swap = ("p0", "p1")

    def engine(shape, be, **kw):
        return tl.TimeloopEngine(ak.ir, a_halos, shape, be, swap=swap, mesh=mesh, **kw)

    # every source of the phase, one nvcc wave: (a)'s applications, (b)'s
    # and (e)'s windows, (c)'s and (d)'s, and the unsharded K1 at DIST_SHAPE
    # of (d)'s reference
    t0 = time.perf_counter()
    plans = []
    for template in ("gmem", "shift"):
        for overlap in (True, False):
            plans += dist.lower_distributed(star.ir, s_halos, MAIN_SHAPE, None,
                                            gmem(1, overlap, template), mesh).plans()
    for ts in DIST_DEPTHS:
        plans += engine(MAIN_SHAPE, gmem(ts)).distributed_window(
            ACOUSTIC_FUSE, ACOUSTIC_FUSE).plans()
    plans += engine(DIST_SHAPE, gmem(2)).distributed_window(
        ACOUSTIC_FUSE, ACOUSTIC_FUSE).plans()
    d_eng = engine(DIST_SHAPE, gmem(1))
    plans += d_eng.distributed_window(ACOUSTIC_FUSE, ACOUSTIC_FUSE).plans()
    plans += d_eng.distributed_window(1, 1).plans()
    plans += tl.TimeloopEngine(star.ir, s_halos, DIST_SHAPE, gmem(1), swap=("v", "u"),
                               mesh=mesh, batch=DIST_BATCH).distributed_window(
        ACOUSTIC_FUSE, ACOUSTIC_FUSE).plans()
    sources = [p.source(torch.float32) for p in plans]
    sources.append(tl.hopper_plans(ak.ir, a_halos, DIST_SHAPE, st.hopper(template="gmem"),
                                   swap)[0].source(torch.float32))
    sources = list(dict.fromkeys(sources))
    if cuda:
        try:
            build.build_many(sources)
        except RuntimeError as e:
            fail(f"distributed build: {e}")
    rec["build"] = {"sources": len(sources), "seconds": time.perf_counter() - t0}
    say(f"distributed: {len(sources)} K4 region and K1 sources built in "
        f"{rec['build']['seconds']:.1f} s")

    def check_rel(label, got, want, tol):
        worst, scale = 0.0, 0.0
        for g, w in want.items():
            if not bool(torch.isfinite(got[g]).all()):
                fail(f"{label}: non-finite field '{g}'")
            worst = max(worst, float((got[g] - w).abs().max()))
            scale = max(scale, float(w.abs().max()))
        if not worst <= tol * max(scale, 1e-30):
            fail(f"{label}: max |sharded - unsharded| = {worst} > {tol} x {scale}")
        return worst, scale

    def only(seen, wrapper, n, label):
        if seen[wrapper] != n or sum(seen.values()) != n:
            fail(f"{label}: launch counts {seen}, expected {n} of {wrapper} "
                 f"and no other")

    map_step, map_step_plain = mods["map_step"], mods["map_step_plain"]

    def regions_vs_plain(win, dt):
        """Every pass of ``win`` (K4 on a region of the shards' padded
        tensors), in place and into a destination of the grid's shape,
        against ``map_step_plain`` on the same seeded tensors (coefficients
        in their physical ranges); fails above DIST_TOL of max(1, |plain|).
        Returns the largest difference."""
        lay, worst = win.layout, 0.0
        gen = torch.Generator(device=device).manual_seed(14)
        for plan in win.plans():
            if plan.kind != "map":
                fail(f"sharded window: a {plan.kind} pass, expected K4 (map)")
            bufs = {g: torch.randn(lay.shape(g), generator=gen, device=device)
                    for g in plan.opnd_grids}
            bufs["vp2"] = 0.5 + 1.5 * bufs["vp2"].abs().clamp(max=1)
            bufs["damp"] = 0.2 * bufs["damp"].abs().clamp(max=1)
            out = torch.randn(lay.shape("p0"), generator=gen, device=device)
            for into in (False, True):
                got, want = ({g: t.clone() for g, t in bufs.items()} for _ in range(2))
                dsts = ({"p0": out.clone()}, {"p0": out.clone()}) if into else (None, None)
                map_step(plan, got, {"dt": dt}, dsts[0])
                map_step_plain(plan, want, {"dt": dt}, dsts[1])
                a = dsts[0]["p0"] if into else got["p0"]
                b = dsts[1]["p0"] if into else want["p0"]
                err = float((a - b).abs().max())
                if not err <= DIST_TOL * max(1.0, float(b.abs().max())):
                    fail(f"sharded window: K4 on region {plan.region} (into a "
                         f"destination: {into}) differs from its plain version by "
                         f"{err}")
                worst = max(worst, err)
            del bufs, got, want, out
        return worst

    # -- (a) per-application --------------------------------------------------
    init = suite.make_grids("star3d4r", MAIN_SHAPE, seed=0, device=device)

    def apps(backend, m=None, n=DIST_APPS):
        grids = {g: x.copy() for g, x in init.items()}

        def run(u, v):
            for _ in range(n):
                st.map(e=u.shape)(star)(u, v)
                (u.data, v.data) = (v.data, u.data)
        sync()
        t0 = time.perf_counter()
        st.launch(backend=backend, mesh=m)(run)(grids["u"], grids["v"])
        sync()
        return time.perf_counter() - t0, {g: x.interior for g, x in grids.items()}

    phase6 = {r["path"]: r["steps_per_s"] for r in map_rows}
    rec["per_application"] = []
    sharded = {}
    for template, wrapper, ename in (("gmem", "map_step", "map_step.gmem"),
                                     ("shift", "stream_step", "stream_step.map")):
        _, want = apps(st.hopper(template=template))
        for overlap in (True, False):
            be = gmem(1, overlap, template)
            apps(be, mesh, 1)                       # warm: load the builds
            reset_counts()
            seconds, got = apps(be, mesh)
            seen = counts()
            per_app = n_sh * ((1 + 2 * 2) if overlap else 1)
            only(seen, wrapper, per_app * DIST_APPS, f"sharded st.map {template} "
                 f"overlap={overlap}")
            key = f"{ename}[star3d4r]"
            sharded[key] = sharded.get(key, 0) + seen[wrapper]
            diff, scale = check_rel(f"sharded st.map {template} overlap={overlap}",
                                    got, want, DIST_TOL)
            row = {"template": template, "overlap": overlap, "apps": DIST_APPS,
                   "launches": seen[wrapper], "seconds": seconds,
                   "steps_per_s": DIST_APPS / seconds,
                   "unsharded_steps_per_s": phase6.get(f"st.map {key}"),
                   "max_abs_diff": diff, "field_max": scale}
            rec["per_application"].append(row)
            say(f"distributed (a) st.map star3d4r {MAIN_SHAPE} {template} "
                f"overlap={overlap}: {DIST_APPS} applications in {seconds:.3f} s = "
                f"{row['steps_per_s']:.1f} steps/s (unsharded, phase 6: "
                f"{row['unsharded_steps_per_s']}); {seen[wrapper]} launches; max "
                f"|sharded - unsharded| {diff:.3g} (field max {scale:.3g})")
        del want
    del init
    if cuda:
        torch.cuda.empty_cache()

    # -- (b) the fused window -------------------------------------------------
    a_init = acoustic.make_fields(MAIN_SHAPE, pml_width=PML_WIDTH, device=device)

    def a_fields():
        return tuple(x.copy() for x in a_init[:4]) + (a_init[4],)

    def a_run(backend, fields, steps=STEPS, m=None):
        p0, p1, vp2, damp, dt = fields
        acoustic.inject_source(p1, 0)

        def between(t, grids):
            acoustic.inject_source(grids["p1"], t)
        sync()
        return st.launch(backend=backend, mesh=m, fuse_steps=ACOUSTIC_FUSE)(
            acoustic.acoustic_target_fused)(p0, p1, vp2, damp, dt, steps,
                                            between=between)

    ref = a_fields()
    a_run(st.hopper(template="gmem"), ref)
    o = acoustic.ORDER
    inner = tuple(slice(o, o + n) for n in MAIN_SHAPE)
    want = {"p0": ref[0].data[inner], "p1": ref[1].data[inner]}
    phase4 = {r["path"]: r["steps_per_s"] for r in main_rows}
    rec["window"] = []
    measured = {}
    for ts in DIST_DEPTHS:
        be = gmem(ts)
        fields = a_fields()
        reset_counts()
        res = a_run(be, fields, m=mesh)
        seen = counts()
        eng = next(e for e in ak._cache.values()
                   if isinstance(e, tl.TimeloopEngine) and e.mesh is mesh
                   and e.backend == be)
        win = eng.distributed_window(ACOUSTIC_FUSE, ACOUSTIC_FUSE)
        n_win = STEPS // ACOUSTIC_FUSE
        spec = win.spec
        per_win = dist.launch_counts(spec, ACOUSTIC_FUSE, True) * n_sh
        only(seen, "map_step", per_win * n_win, f"sharded window time_steps={ts}")
        sharded["map_step.gmem[acoustic_iso]"] = (
            sharded.get("map_step.gmem[acoustic_iso]", 0) + seen["map_step"])
        diff, scale = check_rel(f"sharded window time_steps={ts}",
                                {"p0": fields[0].data[inner], "p1": fields[1].data[inner]},
                                want, DIST_TOL)
        seconds = res.value.seconds
        measured[ts] = seconds
        prof = res.profile
        hooks = n_win - 1
        coll = spec.window_collective_bytes(ACOUSTIC_FUSE, 4)
        # every pass of the window (sub-steps, deep interior, bands), in place
        # and into a destination, against its plain version on the shards'
        # tensors; the launches of this comparison are not counted
        region_err = regions_vs_plain(win, float(a_init[4]))
        # one more window, unprofiled for its wall time, then under the
        # profiler for its device intervals
        f2 = a_fields()
        arrays = {g: f.data for g, f in zip(ak.ir.grid_params, f2[:4])}
        scal = eng.launch_scalars({"dt": f2[4]}, torch.device(device))
        st_ = win.scatter(arrays)
        idle = None
        if cuda:
            sync()
            t0 = time.perf_counter()
            win.advance(st_, scal)
            sync()
            idle = dist_idle(torch, lambda: win.advance(st_, scal),
                             CKPT_ROOT / "dist_window_trace.json",
                             time.perf_counter() - t0)
        del f2, arrays, st_
        row = {"time_steps": ts, "steps": STEPS, "fuse_steps": ACOUSTIC_FUSE,
               "seconds": seconds, "steps_per_s": STEPS / seconds,
               "unsharded_steps_per_s": phase4.get("fused_step[acoustic_iso]"),
               "launches": seen["map_step"], "launches_per_window": per_win,
               "groups": [list(g) for g in spec.group_depths(ACOUSTIC_FUSE)],
               "collective_bytes_per_window": coll,
               "region_vs_plain_max_abs_diff": region_err,
               "gather_s_per_hook": prof.get("gather", 0.0) / (hooks + 1),
               "scatter_s_per_hook": prof.get("scatter", 0.0) / (hooks + 1),
               "kernel_s": prof.get("kernel"), "window_profile": idle,
               "max_abs_diff": diff, "field_max": scale}
        rec["window"].append(row)
        say(f"distributed (b) acoustic {MAIN_SHAPE} K4 gmem time_steps={ts}: "
            f"{STEPS} steps in {seconds:.3f} s = {row['steps_per_s']:.2f} steps/s "
            f"(unsharded K1, phase 4: {row['unsharded_steps_per_s']}); groups "
            f"{row['groups']} a window, {per_win} launches a window, {seen['map_step']} "
            f"in all; {coll} collective bytes a window a shard; {len(win.plans())} "
            f"passes vs plain, max |diff| {region_err:.3g}; gather "
            f"{row['gather_s_per_hook'] * 1e3:.2f} ms and scatter "
            f"{row['scatter_s_per_hook'] * 1e3:.2f} ms around each hook; max "
            f"|sharded - unsharded| {diff:.3g} (field max {scale:.3g})")
        if idle:
            say(f"  one window ({idle['wall_s'] * 1e3:.3f} ms wall, unprofiled): device "
                f"busy {idle['device_busy_s'] * 1e3:.3f} ms (union of all streams), "
                f"idle share {idle['idle_share']:.4f}; K4 {idle['stencil_ms']:.3f} ms, "
                f"slab copies {idle['copy_ms']:.3f} ms on the copy stream, of them "
                f"{idle['overlap_ms']:.3f} ms beside a K4 pass; streams "
                f"{idle['streams']} (compute {idle['compute_streams']}); "
                f"{idle['top_kernels']}")
        del fields
        if cuda:
            torch.cuda.empty_cache()
    del ref, want

    # -- (c) batched ---------------------------------------------------------------
    b_init = [suite.make_grids("star3d4r", DIST_SHAPE, seed=10 * b, device=device)
              for b in range(DIST_BATCH)]

    def star_loop(grids, batch=0):
        st.launch(backend=gmem(1), mesh=mesh, fuse_steps=ACOUSTIC_FUSE)(
            lambda u, v: st.timeloop(DIST_BATCH_STEPS, swap=("v", "u"), batch=batch)(
                star)(u, v))(grids["u"], grids["v"])
    serial = []
    for b in range(DIST_BATCH):
        g = {n: x.copy() for n, x in b_init[b].items()}
        reset_counts()
        star_loop(g)
        serial.append((g, counts()["map_step"]))
    gb = {n: st.grid(st.f32, DIST_SHAPE, star.info.order, batch=DIST_BATCH,
                     device=device) for n in star.ir.grid_params}
    for n in gb:
        gb[n].data.copy_(torch.stack([b_init[b][n].data for b in range(DIST_BATCH)]))
    reset_counts()
    star_loop(gb, DIST_BATCH)
    seen = counts()
    only(seen, "map_step", DIST_BATCH * serial[0][1], "sharded batch")
    for b, (g, _) in enumerate(serial):
        for n in gb:
            if not torch.equal(gb[n].interior[b], g[n].interior):
                fail(f"sharded batch: scenario {b} grid '{n}' differs from its "
                     f"own sharded run")
    rec["batch"] = {"batch": DIST_BATCH, "shape": list(DIST_SHAPE),
                    "steps": DIST_BATCH_STEPS, "launches": seen["map_step"],
                    "serial_launches": [n for _, n in serial], "bit_for_bit": True}
    say(f"distributed (c) star3d4r batch={DIST_BATCH} at {DIST_SHAPE}: every "
        f"scenario bit for bit its own sharded run; {seen['map_step']} K4 launches "
        f"({serial[0][1]} a serial run)")
    del b_init, serial, gb

    # -- (d) the gradient ----------------------------------------------------------
    p0, p1, vp2, damp, dt = acoustic.make_fields(DIST_SHAPE, pml_width=PML_WIDTH,
                                                 device=device)
    acoustic.inject_source(p1, 0)

    def between(t, grids):
        acoustic.inject_source(grids["p1"], t)

    def gradient(backend, m, label):
        fn = st.differentiable_timeloop(ak, p0, p1, vp2, damp, dt,
                                        steps=DIST_GRAD_STEPS, swap=swap,
                                        fuse_steps=ACOUSTIC_FUSE, between=between,
                                        backend=backend, mesh=m)
        arrays = {n: (a.detach().clone().requires_grad_() if n != "damp" else a)
                  for n, a in fn.arrays.items()}
        d = torch.tensor(float(dt), device=device, requires_grad=True)
        adjoint.reset_stats()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        loss = (fn(arrays, {"dt": d})["p1"].double() ** 2).sum()
        sync()
        t1 = time.perf_counter()
        loss.backward()
        sync()
        t2 = time.perf_counter()
        grads = {n: arrays[n].grad for n in ("p0", "p1", "vp2")}
        grads["dt"] = d.grad
        for n, g in grads.items():
            if g is None or not bool(torch.isfinite(g).all()):
                fail(f"sharded adjoint {label}: gradient of {n} missing or not finite")
        return {"backend": label, "loss": float(loss.detach()), "forward_s": t1 - t0,
                "backward_s": t2 - t1, "seconds": dict(adjoint.SECONDS),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
                "launches": counts()}, grads, fn

    drow, dgrads, dfn = gradient(gmem(1), mesh, "sharded K4 gmem")
    win10 = dfn.engine.distributed_window(ACOUSTIC_FUSE, ACOUSTIC_FUSE)
    win1 = dfn.engine.distributed_window(1, 1)
    want_n = (DIST_GRAD_STEPS // ACOUSTIC_FUSE * win10.launches_per_scenario
              + DIST_GRAD_STEPS * win1.launches_per_scenario)
    only(drow["launches"], "map_step", want_n, "sharded adjoint")
    del dfn
    # a planted fault for dt's bound below: the same sharded adjoint with
    # every shard's dt share but the first one's dropped (the psum taken out)
    step_local = dist.ShardedStep.local

    def no_psum(self, i, x, s, masked_args):
        return step_local(self, i, x, {n: v.detach() for n, v in s.items()} if i else s,
                          masked_args)
    dist.ShardedStep.local = no_psum
    try:
        _, fgrads, _ = gradient(gmem(1), mesh, "sharded K4 gmem, no psum")
    finally:
        dist.ShardedStep.local = step_local
    urow, ugrads, _ = gradient(st.hopper(template="gmem"), None, "unsharded K1")
    _, tgrads, _ = gradient(st.torch(), None, "unsharded torch")
    errs = {}
    # interiors: a sharded run keeps each grid's halo with its name (it is
    # the global zero halo), the unsharded one rotates the buffers, halos
    # and all, so the halos' cotangents differ, as in the JAX package.  dt's
    # gradient is a sum over every cell and step that cancels to a small
    # value: in f32 its reduction order alone moves it, so it may also
    # differ by as much as the two unsharded adjoints (K1's and the torch
    # lowering's forward passes) differ from each other.  That bound must
    # still refuse the planted fault above
    box = tuple(slice(acoustic.ORDER, acoustic.ORDER + n) for n in DIST_SHAPE)
    for n, w in ugrads.items():
        got = dgrads[n] if n == "dt" else dgrads[n][box]
        t = tgrads[n] if n == "dt" else tgrads[n][box]
        w = w if n == "dt" else w[box]
        scale = float(w.abs().max())
        err = float((got - w).abs().max())
        floor = float((t - w).abs().max())
        limit = DIST_GRAD_TOL * scale if n != "dt" else max(DIST_GRAD_TOL * scale,
                                                            2 * floor)
        if not err <= limit:
            fail(f"sharded adjoint: gradient of {n} max |sharded - unsharded| = "
                 f"{err} > {limit} (max {scale}; unsharded K1 vs torch {floor})")
        errs[n] = {"max_abs_diff": err, "max": scale, "k1_vs_torch": floor,
                   "limit": limit}
    fault = float((fgrads["dt"] - ugrads["dt"]).abs().max())
    if not fault > errs["dt"]["limit"]:
        fail(f"sharded adjoint: dt's bound {errs['dt']['limit']} does not refuse the "
             f"shards' dt shares left unsummed ({fault})")
    errs["dt"]["no_psum_max_abs_diff"] = fault
    rec["adjoint"] = {"shape": list(DIST_SHAPE), "steps": DIST_GRAD_STEPS,
                      "sharded": drow, "unsharded": urow, "grad_vs_unsharded": errs}
    say(f"distributed (d) gradient acoustic {DIST_SHAPE}, {DIST_GRAD_STEPS} steps: "
        f"sharded forward {drow['forward_s']:.3f} s, backward {drow['backward_s']:.3f} "
        f"s (replay {drow['seconds']['replay']:.3f}, recompute "
        f"{drow['seconds']['recompute']:.3f}, vjp {drow['seconds']['vjp']:.3f}), peak "
        f"{drow['peak_gb']} GB, {drow['launches']['map_step']} K4 launches; unsharded "
        f"K1 forward {urow['forward_s']:.3f} s, backward {urow['backward_s']:.3f} s, "
        f"peak {urow['peak_gb']} GB; gradients: " + ", ".join(
            f"{n} {e['max_abs_diff']:.3g} of max {e['max']:.3g}, limit {e['limit']:.3g} "
            f"(K1 vs torch {e['k1_vs_torch']:.3g})" for n, e in errs.items()) +
        f"; planted fault (dt shares not summed over the shards): dt off by {fault:.3g}")
    del dgrads, ugrads, tgrads, fgrads

    # -- (e) resilience ---------------------------------------------------------------
    arrays0 = {"p0": p0.data, "p1": p1.data, "vp2": vp2.data, "damp": damp.data}

    def r_between(t, arrs):
        arrs = dict(arrs)
        g = st.grid(st.f32, DIST_SHAPE, acoustic.ORDER, data=arrs["p1"])
        acoustic.inject_source(g, t)
        arrs["p1"] = g.data
        return arrs
    r_eng = engine(DIST_SHAPE, gmem(2))
    want = r_eng.run({g: a.clone() for g, a in arrays0.items()}, {"dt": dt},
                     DIST_GRAD_STEPS, ACOUSTIC_FUSE, r_between)
    ckpt = CKPT_ROOT / "distributed"
    shutil.rmtree(ckpt, ignore_errors=True)
    restarts = []
    try:
        got = tl.run_resilient(r_eng, arrays0, {"dt": dt}, DIST_GRAD_STEPS,
                               ACOUSTIC_FUSE, r_between, ckpt_dir=str(ckpt),
                               ckpt_every=1, injector=ft.FailureInjector([DIST_FAIL]),
                               on_restart=lambda n, e: restarts.append(repr(e)))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for g in want:
        if not torch.equal(got[g], want[g]):
            fail(f"sharded run_resilient: '{g}' differs from the uninterrupted run")
    if len(restarts) != 1:
        fail(f"sharded run_resilient: {len(restarts)} restarts, expected 1")
    rec["resilience"] = {"shape": list(DIST_SHAPE), "time_steps": 2,
                         "steps": DIST_GRAD_STEPS, "restarts": len(restarts),
                         "bit_for_bit": True}
    say(f"distributed (e) run_resilient acoustic {DIST_SHAPE} time_steps=2, failure "
        f"before window {DIST_FAIL}: bit for bit the uninterrupted sharded run, "
        f"{len(restarts)} restart")
    del want, got, arrays0, p0, p1, vp2, damp

    # -- (f) pricing ---------------------------------------------------------------
    model = cm.CostModel(calibrate=True, device=device)
    f = a_fields()
    grids = dict(zip(ak.ir.grid_params, f[:4]))
    link = model.rate_for("link", torch.float32, mesh=mesh)
    preds = {ts: model.predict(ak, grids, gmem(ts), ACOUSTIC_FUSE, STEPS, swap,
                               mesh=mesh, scalars={"dt": f[4]})
             for ts in DIST_DEPTHS}
    tuned = at.tune(ak, grids, iters=1, swap=swap, steps=DIST_TUNE_STEPS,
                    space=[(gmem(ts), ACOUSTIC_FUSE) for ts in DIST_DEPTHS],
                    top_k=None, cost_model=model, mesh=mesh, scalars={"dt": f[4]})
    rec["pricing"] = {
        "link": {"bytes_per_s": link.bytes_per_s, "overhead_s": link.overhead_s},
        "predicted_s": {str(ts): p for ts, p in preds.items()},
        "measured_s": {str(ts): s for ts, s in measured.items()},
        "tune": {"winner_time_steps": tuned.backend.time_steps,
                 "trials": [[b.time_steps, fz, s] for b, fz, s in tuned.trials],
                 "steps": DIST_TUNE_STEPS}}
    say(f"distributed (f) link rate {link.bytes_per_s / 1e9:.1f} GB/s, overhead "
        f"{link.overhead_s * 1e6:.1f} us; predicted vs measured ({STEPS} steps): " +
        ", ".join(f"time_steps={ts} {preds[ts]:.3f} s vs {measured[ts]:.3f} s"
                  for ts in DIST_DEPTHS) +
        f"; tune(mesh=) over both ({DIST_TUNE_STEPS} steps): time_steps="
        f"{tuned.backend.time_steps} wins, " + ", ".join(
            f"time_steps={b.time_steps} {s:.3f} s" for b, _, s in tuned.trials))
    del f, grids
    for key, n in sharded.items():
        entries[key]["sharded_launches"] = n
    rec["sharded_launches"] = sharded
    return rec


def fit_depth(api, cfg) -> int:
    """The config's depth if its f32 parameters fit in ``LM_PARAM_GB``,
    else the largest depth whose do (``api.param_count``: meta device)."""
    import dataclasses
    d = cfg.n_layers
    while d > 1 and 4 * api.param_count(dataclasses.replace(cfg, n_layers=d)) \
            > LM_PARAM_GB * 1e9:
        d -= 1
    return d


def lm_serve(torch, np, mods, cfg, params, device):
    """Phase 15 (a): ``LM_REQUESTS`` greedy requests of ``LM_MAX_NEW`` new
    tokens through ``BatchServer`` (audio: ``Generator.generate`` on
    ``LM_FRAMES`` frame embeddings); returns the row."""
    serve_loop = mods["serve_loop"]
    rng = np.random.default_rng(0)
    lo, hi = LM_PROMPT_LEN
    gen = serve_loop.GenConfig(max_new_tokens=LM_MAX_NEW)
    if cfg.family == "audio":
        S = int(rng.integers(lo, hi + 1))
        prompts = rng.integers(0, cfg.vocab, (LM_REQUESTS, S)).astype(np.int32)
        frames = rng.standard_normal((LM_REQUESTS, LM_FRAMES, cfg.d_model),
                                     dtype=np.float32)
        t0 = time.perf_counter()
        out = serve_loop.Generator(cfg, params, gen).generate(
            prompts, frame_embeds=frames)
        results = list(out[:, S:])
        steps = S + LM_MAX_NEW - 1
    else:
        server = serve_loop.BatchServer(cfg, params, batch_size=LM_REQUESTS,
                                        gen=gen)
        plens = [int(rng.integers(lo, hi + 1)) for _ in range(LM_REQUESTS)]
        for n in plens:
            server.submit(rng.integers(0, cfg.vocab, n), LM_MAX_NEW)
        t0 = time.perf_counter()
        done = server.run_until_drained()
        results = [done[u].result for u in sorted(done)]
        # one wave; its context bucketed to a power of two, one decode step
        # a position but the last
        steps = (1 << max(1, (max(plens) + LM_MAX_NEW - 1).bit_length())) - 1
    sync(torch, device)
    wall = time.perf_counter() - t0
    if len(results) != LM_REQUESTS or any(
            len(r) != LM_MAX_NEW or (r < 0).any() or (r >= cfg.vocab).any()
            for r in results):
        fail(f"{cfg.name} serving: results {results}")
    n_tok = LM_REQUESTS * LM_MAX_NEW
    return {"requests": LM_REQUESTS, "new_tokens": n_tok, "decode_steps": steps,
            "seconds": wall, "tokens_per_s": n_tok / wall,
            "ms_per_decode_step": 1e3 * wall / steps,
            "first_result": [int(t) for t in results[0]]}


def lm_decode_check(torch, np, mods, cfg, params, device):
    """Phase 15 (b): in f32, the forward's logits on a prompt against the
    decode steps' logits at the same positions (moe: capacity factor
    n_experts; vlm: text only); returns (max |diff|, max |logit|)."""
    import dataclasses
    api, encdec, L = mods["api"], mods["encdec"], mods["layers"]
    cfg = dataclasses.replace(cfg, dtype="float32")
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.n_experts)))
    gen = torch.Generator(device="cpu").manual_seed(1)
    B = 2
    toks = torch.randint(0, cfg.vocab, (B, LM_CHECK_LEN), generator=gen).to(device)
    if cfg.family == "audio":
        frames = torch.randn((B, LM_FRAMES, cfg.d_model), generator=gen).to(device)
        enc = encdec.encode(params, frames, cfg)
        hid = encdec.decode_train(params, enc, toks, cfg)
        cache = encdec.build_cache(params, enc, cfg, B, LM_CHECK_LEN)
    else:
        hid, _ = api.forward_hidden(cfg, params, {"tokens": toks})
        cache = api.init_cache(cfg, B, api.decode_cache_len(cfg, LM_CHECK_LEN),
                               device=device)
    want = L.unembed(params["embed"], hid, cfg).float()
    got = []
    for i in range(LM_CHECK_LEN):
        logits, cache = api.decode_step(cfg, params, cache, toks[:, i:i + 1])
        got.append(logits[:, 0].float())
    got = torch.stack(got, dim=1)
    if not bool(torch.isfinite(got).all()) or not bool(torch.isfinite(want).all()):
        fail(f"{cfg.name} decode vs forward: non-finite logits")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > LM_CHECK_TOL * scale:
        fail(f"{cfg.name} decode vs forward (f32): max |diff| {err} > "
             f"{LM_CHECK_TOL} * {scale}")
    return err, scale


def lm_train(torch, mods, cfg, device):
    """Phase 15 (c): ``LM_TRAIN_STEPS`` AdamW steps of ``make_train_step``
    on ``train/data.py``'s batches; returns the row."""
    import dataclasses
    train_loop, optimizer, data, shapes = (mods["train_loop"], mods["optimizer"],
                                           mods["data"], mods["shapes"])
    base = reset_peak(torch, device)
    state = train_loop.init_state(cfg, device=device, seed=0)
    n_params = sum(p.numel() for p in optimizer.tree_leaves(state["params"]))
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=LM_TRAIN_SEQ,
                                global_batch=LM_TRAIN_BATCH)
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    step_fn = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        opt=optimizer.OptConfig(warmup_steps=1, total_steps=LM_TRAIN_STEPS)))
    step_s, losses, gnorms = [], [], []
    for s in range(LM_TRAIN_STEPS):
        batch = batch_fn(s)
        sync(torch, device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
        step_s.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) for v in losses + gnorms):
        fail(f"{cfg.name} training: losses {losses}, gradient norms {gnorms}")
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    positions = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    row = {"arch": cfg.name, "n_layers": cfg.n_layers, "params": n_params,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "step_s": step_s,
           "ms_per_step": 1e3 * steady, "tokens_per_s": positions / steady,
           "losses": losses, "grad_norms": gnorms,
           "peak_gb": peak_gb(torch, device, base)}
    del state
    return row


def lm_card_vs_cpu(torch, mods, cfg, device):
    """Phase 15 (d): the loss and every gradient leaf of one batch on
    ``device`` against the CPU, in f32 with TF32 off, on parameters drawn
    once and copied: the loss within ``LM_CPU_LOSS_RTOL``, a leaf within
    ``LM_CPU_GRAD_TOL`` of its max.  A leaf that f32 rounding alone moves
    further (xLSTM's stacked mLSTM normalizers) is held to the CPU in f64
    instead, within ``LM_CPU_F64_TOL``; returns the record."""
    import dataclasses
    api, train_loop, optimizer, data, shapes = (
        mods["api"], mods["train_loop"], mods["optimizer"], mods["data"],
        mods["shapes"])
    cfg = dataclasses.replace(cfg, dtype="float32")
    # seq_len counts the positions: vlm's prefix before the tokens, audio's
    # frames beside them (make_batch_fn gives audio seq_len // 2 of each)
    seq = {"vlm": LM_CPU_TOKENS + cfg.n_prefix_tokens,
           "audio": 2 * LM_CPU_TOKENS}.get(cfg.family, LM_CPU_TOKENS)
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=seq,
                                global_batch=LM_CPU_BATCH)
    batch = data.make_batch_fn(cfg, shape, seed=0)(0)
    # drawn on the device (a truncated normal of 1.7 B draws takes minutes
    # on 8 CPU cores) and copied to the CPU: the same values on both
    params = api.init_params(cfg, device=device, seed=0)

    def run(dev, dt):
        c = dataclasses.replace(cfg, dtype=dt, param_dtype=dt)
        p = optimizer.tree_map(lambda t: t.to(dev, getattr(torch, dt)), params)
        loss, grads = train_loop.make_loss_and_grad(c)(
            p, {k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        return float(loss), [g.cpu() for g in optimizer.tree_leaves(grads)]

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False      # f32 products in f32
    try:
        (loss, got), (want_loss, want) = run(device, "float32"), run("cpu", "float32")
        loss_rel = abs(loss - want_loss) / abs(want_loss)
        if not math.isfinite(loss) or loss_rel > LM_CPU_LOSS_RTOL:
            fail(f"{cfg.name} card vs CPU: loss {loss!r} vs {want_loss!r} "
                 f"(limit {LM_CPU_LOSS_RTOL} of it)")
        rels = []
        for g, w in zip(got, want):
            if not bool(torch.isfinite(g).all()):
                fail(f"{cfg.name} card vs CPU: non-finite gradient {tuple(g.shape)}")
            rels.append(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
        over = [i for i, r in enumerate(rels) if r > LM_CPU_GRAD_TOL]
        row = {"loss_rel_diff": loss_rel, "grad_worst_rel_diff": max(rels),
               "leaves": len(rels), "leaves_over_f32_tol": len(over)}
        if over:
            (_, got64), (_, want64) = run(device, "float64"), run("cpu", "float64")
            worst64 = cpu32 = 0.0
            for i in over:
                scale = float(want64[i].abs().max())
                rel64 = float((got64[i] - want64[i]).abs().max()) / scale
                if rel64 > LM_CPU_F64_TOL:
                    fail(f"{cfg.name} card vs CPU: gradient leaf {i} "
                         f"{tuple(want[i].shape)} {rels[i]} of its max apart in "
                         f"f32 (limit {LM_CPU_GRAD_TOL}) and {rel64} in f64 "
                         f"(limit {LM_CPU_F64_TOL})")
                worst64 = max(worst64, rel64)
                cpu32 = max(cpu32, float((want[i].double() - want64[i]).abs().max())
                            / scale)
            row.update(f64_worst_rel_diff=worst64, cpu_f32_vs_f64_worst_rel=cpu32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    del params
    return row


def sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def reset_peak(torch, device):
    """Frees the cache and restarts the peak count; returns the bytes
    allocated now (what earlier phases still hold), the base of
    ``peak_gb``."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()
    return 0


def peak_gb(torch, device, base):
    """Peak device memory since ``reset_peak`` above its ``base``, GB."""
    if torch.device(device).type == "cuda":
        return (torch.cuda.max_memory_allocated() - base) / 1e9
    return None


def lm_families_phase(torch, np, mods, counters, device="cuda"):
    """Phase 15: (a) serve and (b) check decode against forward for each of
    ``LM_ARCHS`` at its published widths (depth cut as ``fit_depth``
    says), (c) train and (d) hold the card against the CPU for one
    representative a family.  None of K1-K7 runs on these paths: the
    launch counts stay 0.  Returns the record of the phase."""
    import dataclasses
    configs, api = mods["configs"], mods["api"]
    reset_counts, counts = counters
    rec = {"serve": {}, "decode_check": {}, "train": {}, "card_vs_cpu": {}}
    t_phase = time.perf_counter()
    reset_counts()
    for name in LM_ARCHS:
        base = configs.get(name)
        depth = fit_depth(api, base)
        if depth != LM_LAYERS.get(name, base.n_layers):
            fail(f"{name}: {depth} layers fit {LM_PARAM_GB} GB of f32 "
                 f"parameters, LM_LAYERS says {LM_LAYERS.get(name)}")
        cfg = dataclasses.replace(base, n_layers=depth)
        held = reset_peak(torch, device)
        t0 = time.perf_counter()
        params = api.init_params(cfg, device=device, seed=0)
        sync(torch, device)
        init_s = time.perf_counter() - t0
        n_params = api.param_count(cfg)
        row = lm_serve(torch, np, mods, cfg, params, device)
        row.update(arch=name, n_layers=depth, published_layers=base.n_layers,
                   params=n_params, init_s=init_s, dtype=cfg.dtype)
        t0 = time.perf_counter()
        err, scale = lm_decode_check(torch, np, mods, cfg, params, device)
        check_s = time.perf_counter() - t0
        row["peak_gb"] = peak_gb(torch, device, held)
        rec["serve"][name] = row
        rec["decode_check"][name] = {"max_abs_diff": err, "max_abs_logit": scale,
                                     "seconds": check_s}
        say(f"lm {name} ({cfg.family}), {depth} of {base.n_layers} layers, "
            f"{n_params} params (f32) drawn in {init_s:.2f} s: served "
            f"{row['new_tokens']} new tokens in {row['decode_steps']} decode steps "
            f"in {row['seconds']:.3f} s = {row['tokens_per_s']:.2f} tokens/s, "
            f"{row['ms_per_decode_step']:.2f} ms a decode step ({cfg.dtype}); "
            f"decode vs forward (f32): max |diff| {err:.3g} of max |logit| "
            f"{scale:.3g} ({check_s:.1f} s); peak {row['peak_gb']} GB")
        del params
        reset_peak(torch, device)
    for name, kw in LM_TRAIN.items():
        row = lm_train(torch, mods, dataclasses.replace(configs.get(name), **kw),
                       device)
        rec["train"][name] = row
        say(f"lm train {name}, {row['n_layers']} layers, {row['params']} params: "
            f"{LM_TRAIN_STEPS} steps of {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}, "
            f"{', '.join(f'{1e3 * t:.1f}' for t in row['step_s'])} ms a step "
            f"(wall); steady {row['ms_per_step']:.1f} ms = "
            f"{row['tokens_per_s']:.0f} positions/s; losses {row['losses']}; "
            f"peak {row['peak_gb']} GB")
        reset_peak(torch, device)
    for name, kw in LM_CPU.items():
        t0 = time.perf_counter()
        row = lm_card_vs_cpu(torch, mods, dataclasses.replace(
            configs.get(name), **kw), device)
        row["seconds"] = time.perf_counter() - t0
        rec["card_vs_cpu"][name] = row
        say(f"lm card vs CPU {name} ({kw}): loss {row['loss_rel_diff']:.3g} apart "
            f"(limit {LM_CPU_LOSS_RTOL}), worst gradient leaf "
            f"{row['grad_worst_rel_diff']:.3g} of its max (limit "
            f"{LM_CPU_GRAD_TOL}); " + (
                f"{row['leaves_over_f32_tol']} of {row['leaves']} leaves over it in "
                f"f32 (the CPU's own f32 {row['cpu_f32_vs_f64_worst_rel']:.3g} "
                f"from f64) within {row['f64_worst_rel_diff']:.3g} in f64 (limit "
                f"{LM_CPU_F64_TOL})" if row["leaves_over_f32_tol"]
                else f"all {row['leaves']} leaves within it") + f"; {row['seconds']:.1f} s")
        reset_peak(torch, device)
    seen = counts()
    if any(seen.values()):
        fail(f"lm families: launch counts {seen}, expected none of K1-K7")
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"lm families phase: {rec['seconds']:.1f} s")
    return rec


def _timed_steps(torch, device, step_fn, state, batches):
    """Run ``step_fn`` over ``batches``: (state, wall seconds a step,
    losses)."""
    step_s, losses = [], []
    for b in batches:
        sync(torch, device)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        losses.append(float(metrics["loss"]))
        sync(torch, device)
        step_s.append(time.perf_counter() - t0)
    return state, step_s, losses


@contextlib.contextmanager
def timed_statistics(torch, train_loop, device, seconds):
    """``train_loop.moe_statistics`` (MoE's statistics pass) timed, the
    device synchronized around it: each call's seconds appended to
    ``seconds``."""
    inner = train_loop.moe_statistics

    def timed(*a, **k):
        sync(torch, device)
        t0 = time.perf_counter()
        out = inner(*a, **k)
        sync(torch, device)
        seconds.append(time.perf_counter() - t0)
        return out
    train_loop.moe_statistics = timed
    try:
        yield seconds
    finally:
        train_loop.moe_statistics = inner


def _steady_ms(step_s) -> float:
    rest = step_s[1:] or step_s
    return 1e3 * sorted(rest)[len(rest) // 2]


def sharded_gates(torch, mods, cfg, mesh, batch, device, adamw=True):
    """Phase 16 in f32 (or f64) compute: the sharded loss and gradients
    against the unsharded ones on the same parameters and batch (MoE: the
    load-balancing loss too); then (``adamw``) one sharded AdamW step and
    its replicas.  Returns the record."""
    api, train_loop, optimizer, sharding = (mods["api"], mods["train_loop"],
                                            mods["optimizer"], mods["sharding"])
    base = reset_peak(torch, device)
    t0 = time.perf_counter()
    params = api.init_params(cfg, device=device, seed=0)
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    loss_u, grads_u = train_loop.make_loss_and_grad(cfg)(params, tb)
    sync(torch, device)
    t1 = time.perf_counter()
    if cfg.moe:                      # the unsharded load-balancing loss
        with torch.no_grad():
            aux_u = float(api.loss_fn(cfg, params, tb)[1]["aux"])
    placed = sharding.device_put(params, train_loop.state_shardings(cfg, mesh)["params"],
                                 donate=True)
    del params
    sync(torch, device)
    t2 = time.perf_counter()
    fn = train_loop.make_sharded_loss_and_grad(cfg, mesh)
    with timed_statistics(torch, train_loop, device, []) as stats_s:
        loss_s, grads_s, metrics_s = fn(placed, batch)
    lu, ls = float(loss_u), float(loss_s)
    sync(torch, device)
    t3 = time.perf_counter()
    if not (math.isfinite(ls) and abs(ls - lu) <= SHARD_LOSS_RTOL * abs(lu)):
        fail(f"sharded training (f32): loss {ls!r}, unsharded {lu!r} (limit "
             f"{SHARD_LOSS_RTOL} relative)")
    worst, worst_leaf = 0.0, None
    for (name, a), (_, b) in zip(_named_leaves(grads_s), _named_leaves(grads_u)):
        g = a.gather()
        scale = max(float(b.abs().max()), 1e-30)
        e = float((g - b).abs().max()) / scale
        if not bool(torch.isfinite(g).all()) or e > SHARD_GRAD_TOL:
            fail(f"sharded training (f32): gradient {name} {e} of its max "
                 f"from the unsharded one (limit {SHARD_GRAD_TOL})")
        if e >= worst:
            worst, worst_leaf = e, name
        del g
    del grads_s, grads_u, loss_u, loss_s
    rec = {"loss_sharded": ls, "loss_unsharded": lu,
           "loss_rel_diff": abs(ls - lu) / abs(lu), "grad_worst_rel_diff": worst,
           "grad_worst_leaf": worst_leaf, "unsharded_loss_and_grad_s": t1 - t0,
           "place_s": t2 - t1, "sharded_loss_and_grad_s": t3 - t2}
    aux_line = ""
    if cfg.moe:
        aux_s = float(metrics_s["aux"])
        rec.update(aux_sharded=aux_s, aux_unsharded=aux_u,
                   aux_rel_diff=abs(aux_s - aux_u) / abs(aux_u),
                   stats_pass_s=sum(stats_s))
        if not abs(aux_s - aux_u) <= SHARD_AUX_RTOL * abs(aux_u):
            fail(f"sharded training ({cfg.name}): load-balancing loss {aux_s!r}, "
                 f"unsharded {aux_u!r} (limit {SHARD_AUX_RTOL} relative)")
        aux_line = (f"; load-balancing loss {aux_s!r} vs {aux_u!r} (relative "
                    f"{rec['aux_rel_diff']:.3g}, limit {SHARD_AUX_RTOL}), statistics "
                    f"pass {sum(stats_s):.3f} s")
    line = (f"sharded training gates ({cfg.dtype}, {cfg.name} {cfg.n_layers} layers, "
            f"{batch['tokens'].shape[0]} x {batch['tokens'].shape[1]}, mesh "
            f"{mesh.shape}): loss {ls!r} vs unsharded {lu!r} (relative "
            f"{rec['loss_rel_diff']:.3g}, limit {SHARD_LOSS_RTOL}); worst gradient "
            f"leaf {worst_leaf} {worst:.3g} of its max (limit {SHARD_GRAD_TOL}); "
            f"loss and gradients {t3 - t2:.2f} s sharded, {t1 - t0:.2f} s not"
            + aux_line)
    if adamw:
        tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=1,
                                                            total_steps=2))
        state = {"params": placed, "opt": optimizer.init(placed), "step": 0}
        _, step = train_loop.compile_train_step(cfg, tc, mesh, batch)
        state, _ = step(state, batch)
        blocks = copies = 0
        for part in (state["params"], state["opt"]["m"], state["opt"]["v"]):
            for leaf in optimizer.tree_leaves(part):
                for reps in leaf.replicas():
                    blocks += 1
                    copies += len(reps) - 1
                    if not all(torch.equal(r, reps[0]) for r in reps[1:]):
                        fail("sharded training: a replica differs from its block")
        rec.update(blocks=blocks, replica_copies=copies)
        line += (f"; after one AdamW step {blocks} blocks, {copies} replica "
                 f"copies on other devices, each equal to its primary")
        del state
    rec["peak_gb"] = peak_gb(torch, device, base)
    say(f"{line}; peak {rec['peak_gb']} GB")
    del placed
    return rec


def _named_leaves(tree, pre=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{pre}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{pre}/{i}")
    else:
        yield pre, tree


def sharded_train_phase(torch, mods, counters, rates, device="cuda"):
    """Phase 16: (a) ``TRAIN_ARCH`` cut to ``TRAIN_LAYERS`` on a
    ``SHARD_MESH`` mesh of the card: f32 gates, timed bf16 steps sharded
    and not, K6 on a model shard's slice; (b) ``FULL_ARCH`` whole on the
    production mesh: f32 gates, then ``launch.train --preset full``
    against the unsharded bf16 loss.  Returns (the record, the kernels-line entry of K6 at a model
    shard's shape)."""
    import dataclasses
    configs, train_loop, optimizer, data, shapes, mesh_mod, api = (
        mods["configs"], mods["train_loop"], mods["optimizer"], mods["data"],
        mods["shapes"], mods["mesh"], mods["api"])
    conv, conv_ops, conv_ref, train_cli = (mods["conv"], mods["conv_ops"],
                                           mods["conv_ref"], mods["train_cli"])
    reset_counts, counts = counters
    t_phase = time.perf_counter()
    devices = None if torch.device(device).type == "cuda" else [device]
    gc.collect()
    rec = {"held_gb": reset_peak(torch, device) / 1e9}
    say(f"sharded training phase: {rec['held_gb']:.2f} GB held by earlier phases")

    # -- (a) --------------------------------------------------------------------
    base_cfg = dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    mesh = mesh_mod.make_mesh(SHARD_MESH, ("data", "model"), devices)
    shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=TRAIN_SEQ,
                                global_batch=TRAIN_BATCH)
    cfg32 = dataclasses.replace(base_cfg, dtype="float32")
    rec["gates"] = sharded_gates(torch, mods, cfg32, mesh,
                                 data.make_batch_fn(cfg32, shape, seed=0)(0), device)
    reset_peak(torch, device)

    cfg = base_cfg
    n_rec = mods["griffin"].block_types(cfg).count("rec")
    batch_fn = data.make_batch_fn(cfg, shape, seed=0)
    batches = [batch_fn(s) for s in range(SHARD_STEPS)]
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(warmup_steps=1,
                                                        total_steps=SHARD_STEPS))
    base = reset_peak(torch, device)
    state = train_loop.init_state(cfg, device=device, seed=0)
    state, step_u, losses_u = _timed_steps(torch, device,
                                           train_loop.make_train_step(cfg, tc),
                                           state, batches)
    peak_u = peak_gb(torch, device, base)
    del state
    base = reset_peak(torch, device)
    state = train_loop.init_sharded_state(cfg, mesh, seed=0)
    plan, step = train_loop.compile_train_step(cfg, tc, mesh, batches[0])
    captured = {}
    kernel = conv_ops.causal_conv1d

    def capture(x, w):                 # one model shard's forward K6 input
        if "x" not in captured and x.shape[0] == TRAIN_BATCH // SHARD_MESH[0]:
            captured["x"], captured["w"] = x.clone(), w.clone()
        return kernel(x, w)
    conv_ops.causal_conv1d = capture
    sync(torch, device)
    reset_counts()
    conv_ref.causal_conv1d_ref.calls = 0
    try:
        state, step_s, losses_s = _timed_steps(torch, device, step, state, batches)
    finally:
        conv_ops.causal_conv1d = kernel
    seen = counts()
    plain_calls = conv_ref.causal_conv1d_ref.calls
    peak_s = peak_gb(torch, device, base)
    want = 3 * n_rec * SHARD_MESH[1] * SHARD_MESH[0] * SHARD_STEPS
    if seen["causal_conv1d"] != want or plain_calls \
            or sum(seen.values()) != seen["causal_conv1d"]:
        fail(f"sharded training: launch counts {seen} and {plain_calls} calls "
             f"of K6's plain version over {SHARD_STEPS} steps; expected {want} "
             f"of causal_conv1d (3 x {n_rec} recurrent layers x {SHARD_MESH[1]} "
             f"model shards x {SHARD_MESH[0]} data groups a step) and nothing else")
    if not all(math.isfinite(v) for v in losses_s):
        fail(f"sharded training: losses {losses_s}")
    del state
    reset_peak(torch, device)
    rec["train"] = {
        "arch": cfg.name, "n_layers": cfg.n_layers, "mesh": list(SHARD_MESH),
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "dtype": cfg.dtype,
        "steps": SHARD_STEPS, "sharded_step_s": step_s, "unsharded_step_s": step_u,
        "sharded_ms_per_step": _steady_ms(step_s),
        "unsharded_ms_per_step": _steady_ms(step_u),
        "sharded_losses": losses_s, "unsharded_losses": losses_u,
        "first_loss_rel_diff_bf16": abs(losses_s[0] - losses_u[0]) / abs(losses_u[0]),
        "sharded_peak_gb": peak_s, "unsharded_peak_gb": peak_u,
        "launches": seen, "k6_launches": seen["causal_conv1d"],
        "state_bytes_per_shard": plan.state_bytes_per_shard}
    r = rec["train"]
    say(f"sharded training ({cfg.dtype}, mesh {mesh.shape}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}): {', '.join(f'{1e3 * t:.1f}' for t in step_s)} ms a step "
        f"(wall), steady {r['sharded_ms_per_step']:.1f} ms, peak {peak_s} GB; "
        f"unsharded {', '.join(f'{1e3 * t:.1f}' for t in step_u)} ms, steady "
        f"{r['unsharded_ms_per_step']:.1f} ms, peak {peak_u} GB; losses "
        f"{losses_s} vs {losses_u} (first {r['first_loss_rel_diff_bf16']:.3g} "
        f"apart in bf16); K6 {seen['causal_conv1d']} launches = 3 x {n_rec} x "
        f"{SHARD_MESH[1]} x {SHARD_MESH[0]} x {SHARD_STEPS}")

    # one model shard's K6 input from the run: bit for bit, timed
    if "x" not in captured:
        fail("sharded training: no model shard's K6 input was seen")
    x, w = captured["x"], captured["w"]
    want_y = conv_ref.causal_conv1d_ref(x, w)
    got_y = conv.causal_conv1d_cuda(x, w) if torch.device(device).type == "cuda" \
        else conv_ref.causal_conv1d_ref(x, w)
    sync(torch, device)
    B, T, W = x.shape
    key = f"causal_conv1d sharded {str(x.dtype).split('.')[1]} [{B}, {T}, {W}]"
    if not torch.equal(got_y, want_y):
        fail(f"{key}: K6 on a model shard's slice differs from its plain "
             f"version by {float((got_y.float() - want_y.float()).abs().max())}")
    say(f"kernel {key} (one model shard's input from the sharded step): bit "
        f"for bit its plain version")
    entry = None
    if torch.device(device).type == "cuda":
        row = conv_times(torch, torch.nn.functional, rates, conv, conv_ref, x, w,
                         want_y, "train", key)
        row.update(shape=[B, T, W], dtype=str(x.dtype).split(".")[1],
                   build=conv.build_of(x, w, want_y))
        entry = conv_entry_of("causal_conv1d.sharded", row, "sharded training")
        entry["launches"], entry["max_abs_err"] = seen["causal_conv1d"], 0.0
        entry["sharded_launches"] = seen["causal_conv1d"]
        rec["k6_shard"] = row
    del x, w, want_y, got_y, captured

    # -- (b) --------------------------------------------------------------------
    cfg_b = configs.get(FULL_ARCH)
    shape_b = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=FULL_SEQ,
                                  global_batch=FULL_BATCH)
    batch0 = data.make_batch_fn(cfg_b, shape_b, seed=0)(0)
    rec["full_gates"] = sharded_gates(
        torch, mods, dataclasses.replace(cfg_b, dtype="float32"),
        mesh_mod.make_production_mesh(devices=devices), batch0, device,
        adamw=False)
    rec["full"] = full_cli_run(torch, mods, counters, FULL_ARCH, FULL_BATCH, FULL_SEQ,
                               FULL_STEPS, device)
    reset_peak(torch, device)
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"sharded training phase: {rec['seconds']:.1f} s")
    return rec, entry


def full_cli_run(torch, mods, counters, arch, batch, seq, steps, device):
    """The CLI's ``--preset full`` for ``arch`` whole on the production mesh
    of the card, ``batch`` x ``seq``, ``steps`` steps at the config's bf16:
    the first loss within ``TRAIN_LOSS_RTOL`` of the unsharded loss on the
    same parameters and batch (a forward pass: the first step's loss is
    that of the parameters it starts from, and a whole unsharded step may
    not fit beside what earlier phases hold).  Returns the row."""
    import dataclasses
    configs, train_loop, data, shapes, api, train_cli = (
        mods["configs"], mods["train_loop"], mods["data"], mods["shapes"],
        mods["api"], mods["train_cli"])
    reset_counts, counts = counters
    cfg_b = configs.get(arch)
    shape_b = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=seq,
                                  global_batch=batch)
    batch0 = data.make_batch_fn(cfg_b, shape_b, seed=0)(0)
    base = reset_peak(torch, device)
    params = api.init_params(cfg_b, device=device, seed=0)
    sync(torch, device)
    t0 = time.perf_counter()
    with torch.no_grad():
        loss_u, _ = api.loss_fn(cfg_b, params, {
            k: torch.as_tensor(v, device=device) for k, v in batch0.items()})
        lu = float(loss_u)
    su = time.perf_counter() - t0
    peak_bu = peak_gb(torch, device, base)
    del params, loss_u
    base = reset_peak(torch, device)
    cli_s = []
    compile_step = train_loop.compile_train_step

    def timed_compile(*a, **k):
        plan_, step_ = compile_step(*a, **k)

        def run(state_, batch_):
            sync(torch, device)
            t1 = time.perf_counter()
            out = step_(state_, batch_)
            float(out[1]["loss"])
            sync(torch, device)
            cli_s.append(time.perf_counter() - t1)
            return out
        return plan_, run
    argv = ["--preset", "full", "--arch", arch, "--global-batch", str(batch),
            "--seq-len", str(seq), "--steps", str(steps)]
    if torch.device(device).type != "cuda":
        argv += ["--device", str(device)]
    train_loop.compile_train_step = timed_compile
    reset_counts()
    t0 = time.perf_counter()
    try:
        losses = train_cli.main(argv)
    finally:
        train_loop.compile_train_step = compile_step
    cli_total = time.perf_counter() - t0
    seen = counts()
    peak_bs = peak_gb(torch, device, base)
    diff = abs(losses[0] - lu) / abs(lu)
    if any(seen.values()):
        fail(f"launch.train --preset full {arch}: launch counts {seen}, expected none")
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
            and diff <= TRAIN_LOSS_RTOL):
        fail(f"launch.train --preset full {arch}: losses {losses}, the unsharded "
             f"loss {lu!r} ({diff:.3g} apart, limit {TRAIN_LOSS_RTOL})")
    n_params = api.param_count(cfg_b)
    row = {"arch": arch, "params": n_params, "mesh": [16, 16], "batch": batch,
           "seq": seq, "dtype": cfg_b.dtype, "losses": losses, "unsharded_loss": lu,
           "first_loss_rel_diff": diff, "sharded_step_s": cli_s,
           "unsharded_forward_s": [su], "cli_seconds": cli_total,
           "sharded_peak_gb": peak_bs, "unsharded_peak_gb": peak_bu}
    say(f"launch.train --preset full {arch} ({n_params} params, "
        f"{cfg_b.dtype}) on the production mesh (16, 16) of one card, "
        f"{batch} x {seq}: losses {losses}, first {diff:.3g} from the "
        f"unsharded loss {lu!r} (limit {TRAIN_LOSS_RTOL}, bf16); "
        f"{', '.join(f'{t:.2f}' for t in cli_s)} s a step, peak {peak_bs} GB "
        f"(CLI {cli_total:.1f} s in all); the unsharded forward {su:.2f} s, "
        f"peak {peak_bu} GB")
    reset_peak(torch, device)
    return row


def family_cfg(configs, name, kw):
    """``name``'s config with ``kw`` replaced."""
    import dataclasses
    return dataclasses.replace(configs.get(name), **kw)


def sharded_families_phase(torch, mods, counters, lm_rec, device="cuda"):
    """Phase 16 (c): ``FAMILY_ARCHS`` on a ``SHARD_MESH`` mesh of the card:
    f32 gates (xLSTM f64; mixtral at its published capacity with tokens
    dropped, its load-balancing loss too), then ``FAMILY_STEPS`` timed bf16
    steps beside phase 15 (c)'s unsharded step (``lm_rec``); (d) the CLI's
    ``--preset full`` for ``AUDIO_FULL_ARCH`` on the production mesh.  No
    K1-K7 launch.  Returns the record."""
    import dataclasses
    configs, train_loop, optimizer, data, shapes, mesh_mod = (
        mods["configs"], mods["train_loop"], mods["optimizer"], mods["data"],
        mods["shapes"], mods["mesh"])
    reset_counts, counts = counters
    t_phase = time.perf_counter()
    devices = None if torch.device(device).type == "cuda" else [device]
    mesh = mesh_mod.make_mesh(SHARD_MESH, ("data", "model"), devices)
    rec = {"gates": {}, "train": {}}
    reset_counts()
    for name in FAMILY_ARCHS:
        t0 = time.perf_counter()
        dt = "float64" if name.startswith("xlstm") else "float32"
        cfg = dataclasses.replace(family_cfg(configs, name, LM_CPU[name]), dtype=dt,
                                  param_dtype=dt)
        if cfg.moe:
            B, seq = MOE_GATE_BATCH, MOE_GATE_SEQ
        else:
            B = LM_CPU_BATCH
            seq = {"vlm": LM_CPU_TOKENS + cfg.n_prefix_tokens,
                   "audio": 2 * LM_CPU_TOKENS}.get(cfg.family, LM_CPU_TOKENS)
        shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=seq,
                                    global_batch=B)
        row = sharded_gates(torch, mods, cfg, mesh,
                            data.make_batch_fn(cfg, shape, seed=0)(0), device,
                            adamw=False)
        row.update(batch=B, seq=seq, dtype=dt, seconds=time.perf_counter() - t0)
        rec["gates"][name] = row
        reset_peak(torch, device)
    for name in FAMILY_ARCHS:
        cfg = family_cfg(configs, name, LM_TRAIN[name])
        shape = dataclasses.replace(shapes.SHAPES["train_4k"], seq_len=LM_TRAIN_SEQ,
                                    global_batch=FAMILY_BATCH)
        batch_fn = data.make_batch_fn(cfg, shape, seed=0)
        batches = [batch_fn(s) for s in range(FAMILY_STEPS)]
        tc = train_loop.TrainConfig(opt=optimizer.OptConfig(
            warmup_steps=1, total_steps=FAMILY_STEPS))
        base = reset_peak(torch, device)
        state = train_loop.init_sharded_state(cfg, mesh, seed=0)
        _, step = train_loop.compile_train_step(cfg, tc, mesh, batches[0])
        with timed_statistics(torch, train_loop, device, []) as stats_s:
            state, step_s, losses = _timed_steps(torch, device, step, state, batches)
        peak = peak_gb(torch, device, base)
        del state
        reset_peak(torch, device)
        if not all(math.isfinite(v) for v in losses):
            fail(f"sharded training {name}: losses {losses}")
        u = lm_rec["train"].get(name, {})
        row = {"arch": name, "n_layers": cfg.n_layers, "mesh": list(SHARD_MESH),
               "batch": FAMILY_BATCH, "seq": LM_TRAIN_SEQ, "dtype": cfg.dtype,
               "sharded_step_s": step_s, "sharded_ms_per_step": _steady_ms(step_s),
               "losses": losses, "sharded_peak_gb": peak,
               "unsharded_ms_per_step_1_row": u.get("ms_per_step"),
               "unsharded_peak_gb_1_row": u.get("peak_gb")}
        if cfg.moe:
            row["stats_pass_s"] = stats_s
        rec["train"][name] = row
        say(f"sharded training {name} ({cfg.dtype}, {cfg.n_layers} layers, mesh "
            f"{mesh.shape}, {FAMILY_BATCH} x {LM_TRAIN_SEQ}): "
            f"{', '.join(f'{1e3 * t:.1f}' for t in step_s)} ms a step (wall), steady "
            f"{row['sharded_ms_per_step']:.1f} ms, peak {peak} GB"
            + (f", MoE statistics pass {', '.join(f'{1e3 * t:.1f}' for t in stats_s)}"
               f" ms" if cfg.moe else "")
            + f"; unsharded (phase 15 (c), 1 x {LM_TRAIN_SEQ}) "
            f"{row['unsharded_ms_per_step_1_row']} ms, peak "
            f"{row['unsharded_peak_gb_1_row']} GB; losses {losses}")
    seen = counts()
    if any(seen.values()):
        fail(f"sharded families: launch counts {seen}, expected none of K1-K7")
    rec["audio_full"] = full_cli_run(torch, mods, counters, AUDIO_FULL_ARCH,
                                     AUDIO_FULL_BATCH, AUDIO_FULL_SEQ,
                                     AUDIO_FULL_STEPS, device)
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"sharded families phase: {rec['seconds']:.1f} s")
    return rec


def _serve_inputs(np, cfg, B, prompt, frames):
    """A prefill batch of ``B`` rows (VLM: its prefix embeddings; audio:
    ``frames`` frame embeddings) and the prompts, from a fixed seed."""
    rng = np.random.default_rng(17)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, prompt)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_prefix_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal((B, frames, cfg.d_model),
                                                    dtype=np.float32)
    return batch


def _greedy(torch, device, step, params, cache, toks, new):
    """The prompt ``toks`` fed a token a step, then ``new`` greedy tokens:
    (the new tokens, wall seconds a step)."""
    cur, out, step_s = toks[:, :1], [], []
    S = toks.shape[1]
    for t in range(S + new - 1):
        sync(torch, device)
        t0 = time.perf_counter()
        nxt, cache = step(params, cache, cur)
        nxt = nxt.to(device)
        sync(torch, device)
        step_s.append(time.perf_counter() - t0)
        if t + 1 < S:
            cur = toks[:, t + 1:t + 2]
        else:
            cur = nxt
            out.append(nxt)
    return torch.cat(out, dim=1), step_s


def sharded_serve_one(torch, np, mods, counters, cfg, mesh, B, prompt, new,
                      cache_len, device, capture=None, prompt_cache=False):
    """Phase 17 for one config: the unsharded prefill and greedy decode,
    then (the parameters moved onto ``mesh``) the sharded ones; the gates;
    returns (the row, K6's launches of the sharded prefill as ``capture``
    caught them; ``capture`` then holds those of the sharded decode).  The
    prompt goes into the cache a token a decode step, or
    (``prompt_cache``, the transformer family) through the port's
    unsharded ``transformer.prefill``, the cache it builds placed by
    ``cache_shardings``; then ``new`` greedy decode steps from the token
    the unsharded prefill picks.  Both peaks count from what was
    allocated before the parameters were drawn."""
    api, sharding, encdec, serve_loop, dryrun = (
        mods["api"], mods["sharding"], mods["encdec"], mods["serve_loop"],
        mods["dryrun"])
    reset_counts, counts = counters
    batch = _serve_inputs(np, cfg, B, SERVE17_PREFILL.get(cfg.name, prompt),
                          LM_FRAMES)
    tb = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    toks = tb["tokens"][:, :prompt]
    base = reset_peak(torch, device)
    params = api.init_params(cfg, device=device, seed=0)

    def new_cache():
        if prompt_cache:
            return mods["transformer"].prefill(params, tb["tokens"][:, :prompt], cfg,
                                               cache_len)[1]
        if cfg.family == "audio":
            enc = encdec.encode(params, tb["frame_embeds"], cfg)
            return encdec.build_cache(params, enc, cfg, B, cache_len)
        return api.init_cache(cfg, B, api.decode_cache_len(cfg, cache_len),
                              device=device)
    with torch.no_grad():
        want = dryrun.make_prefill_step(cfg)(params, tb).float()
        cache = new_cache()
        kept = new_cache() if cfg.family == "audio" else None
        if prompt_cache:
            toks = want[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        want_t, u_s = _greedy(torch, device, serve_loop.make_serve_step(cfg), params,
                              cache, toks, new)
        del cache
        spec = kept if kept is not None else new_cache()
    peak_u = peak_gb(torch, device, base)
    reset_peak(torch, device)
    placed = sharding.device_put(params, sharding.param_shardings(
        cfg, mesh, api.init_params(cfg, device="meta")), donate=True)
    del params
    _, prefill = dryrun.compile_prefill_step(cfg, mesh, batch)
    reset_counts()
    if capture is not None:
        capture.clear()
    got = prefill(placed, batch).gather().float()
    pre_seen = counts()
    pre_calls = list(capture) if capture is not None else []
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    if not bool(torch.isfinite(got).all()) or err > SERVE17_TOL * scale:
        fail(f"sharded prefill {cfg.name}: max |diff| {err} of max |logit| {scale} "
             f"(limit {SERVE17_TOL})")
    plan, step = mods["serve_loop"].compile_serve_step(cfg, mesh, spec)
    scache = sharding.device_put(spec, plan.cache_shardings, donate=True)
    del spec, kept
    reset_counts()
    if capture is not None:
        capture.clear()
    got_t, s_s = _greedy(torch, device, step, placed, scache, toks, new)
    seen = counts()
    peak_s = peak_gb(torch, device, base)
    if not torch.equal(got_t.cpu(), want_t.cpu()):
        fail(f"sharded decode {cfg.name}: greedy tokens {got_t.tolist()}, unsharded "
             f"{want_t.tolist()}")
    del placed, scache
    steps = len(s_s)
    return {"arch": cfg.name, "n_layers": cfg.n_layers, "mesh": list(mesh.devices.shape),
            "dtype": cfg.dtype, "batch": B, "prompt": prompt,
            "prefill_prompt": batch["tokens"].shape[1], "new_tokens": new,
            "cache_len": cache_len, "kv_mode": plan.kv_mode,
            "prompt_by": "transformer.prefill" if prompt_cache else "decode steps",
            "prefill_max_abs_diff": err, "max_abs_logit": scale,
            "tokens": got_t.cpu().tolist(), "decode_steps": steps,
            "sharded_ms_per_decode_step": _steady_ms(s_s),
            "unsharded_ms_per_decode_step": _steady_ms(u_s),
            "sharded_peak_gb": peak_s, "unsharded_peak_gb": peak_u,
            "prefill_launches": pre_seen, "launches": seen}, pre_calls


def sharded_serve_phase(torch, np, mods, counters, rates, device="cuda"):
    """Phase 17: (a) ``SERVE17`` on a ``SERVE_MESH`` mesh of the card in
    f32; (b) ``GRANITE17_ARCH`` whole on the production mesh, the cache
    split by sequence.  Every K6 launch of the sharded prefill and decode is
    held bit for bit against its plain version and counted.  Returns (the
    record, the kernels-line entries of K6 at a model shard's prefill and
    decode shapes)."""
    import dataclasses
    configs, conv, conv_ops, conv_ref, mesh_mod = (
        mods["configs"], mods["conv"], mods["conv_ops"], mods["conv_ref"], mods["mesh"])
    t_phase = time.perf_counter()
    devices = None if torch.device(device).type == "cuda" else [device]
    rec = {"held_gb": reset_peak(torch, device) / 1e9, "serve": {}}
    mesh = mesh_mod.make_mesh(SERVE_MESH, ("data", "model"), devices)
    captured = []
    kernel = conv_ops.causal_conv1d

    def capture(x, w):                    # every K6 launch, its output beside
        y = kernel(x, w)
        captured.append((x.clone(), w.clone(), y.clone()))
        return y
    entries = []

    def k6_checked(name, kind, calls, seen, want, per):
        """``calls`` (K6's launches of the sharded ``kind``) bit for bit
        their plain version, ``want`` of them (``per``); their kernels-line
        entry (None off the card) and row fields."""
        if seen["causal_conv1d"] != want or sum(seen.values()) != want \
                or len(calls) != want:
            fail(f"sharded {kind} {name}: launch counts {seen}, {len(calls)} K6 "
                 f"calls seen; expected {want} of causal_conv1d ({per})")
        for x, w, y in calls:
            ref = conv_ref.causal_conv1d_ref(x, w)
            if not torch.equal(y, ref):
                fail(f"sharded {kind} {name}: K6 on a model shard's slice "
                     f"{tuple(x.shape)} differs from its plain version by "
                     f"{float((y.float() - ref.float()).abs().max())}")
        x, w, y = calls[0]
        B_, T_, W_ = x.shape
        key = (f"causal_conv1d sharded {kind} {str(x.dtype).split('.')[1]} "
               f"[{B_}, {T_}, {W_}]")
        say(f"kernel {key}: all {want} launches of the sharded {kind} bit for "
            f"bit their plain version")
        fields = {f"k6_{kind}_launches": want, f"k6_{kind}_shape": [B_, T_, W_]}
        if torch.device(device).type != "cuda":
            return None, fields
        t = conv_times(torch, torch.nn.functional, rates, conv, conv_ref,
                       x, w, y, kind, key)
        t.update(shape=[B_, T_, W_], dtype=str(x.dtype).split(".")[1],
                 build=conv.build_of(x, w, y))
        e = conv_entry_of(f"causal_conv1d.sharded_{kind}", t, "sharded serving")
        e["launches"], e["max_abs_err"], e["sharded_launches"] = want, 0.0, want
        fields[f"k6_{kind}_times"] = t
        return e, fields
    for name, kw in SERVE17.items():
        t0 = time.perf_counter()
        cfg = dataclasses.replace(family_cfg(configs, name, kw), dtype="float32")
        hybrid = cfg.family == "hybrid"
        conv_ops.causal_conv1d = capture if hybrid else kernel
        try:
            row, pre_calls = sharded_serve_one(
                torch, np, mods, counters, cfg, mesh, SERVE17_BATCH, SERVE17_PROMPT,
                SERVE17_NEW, SERVE17_PROMPT + SERVE17_NEW, device,
                captured if hybrid else None)
        finally:
            conv_ops.causal_conv1d = kernel
        seen = row["launches"]
        if hybrid:
            n_rec = mods["griffin"].block_types(cfg).count("rec")
            shards = (f"{n_rec} recurrent layers x {SERVE_MESH[1]} model shards x "
                      f"{SERVE_MESH[0]} data groups")
            per_pass = n_rec * SERVE_MESH[0] * SERVE_MESH[1]
            for kind, calls, seen_, want, per in (
                    ("prefill", pre_calls, row["prefill_launches"], per_pass, shards),
                    ("decode", captured, seen, per_pass * row["decode_steps"],
                     f"{shards} x {row['decode_steps']} steps")):
                e, fields = k6_checked(name, kind, calls, seen_, want, per)
                row.update(fields)
                if e is not None:
                    entries.append(e)
            del pre_calls
            captured.clear()
        elif any(seen.values()) or any(row["prefill_launches"].values()):
            fail(f"sharded serving {name}: launch counts {seen} (decode), "
                 f"{row['prefill_launches']} (prefill), expected none")
        row["seconds"] = time.perf_counter() - t0
        rec["serve"][name] = row
        say(f"sharded serving {name} ({cfg.n_layers} layers, f32, mesh "
            f"{mesh.shape}, kv_mode {row['kv_mode']}): prefill logits {row['prefill_max_abs_diff']:.3g} "
            f"from the unsharded of max |logit| {row['max_abs_logit']:.3g} (limit "
            f"{SERVE17_TOL}); {SERVE17_NEW} greedy tokens x {SERVE17_BATCH} rows token "
            f"for token the unsharded; {row['sharded_ms_per_decode_step']:.1f} ms a "
            f"decode step sharded, {row['unsharded_ms_per_decode_step']:.1f} "
            f"unsharded; peak {row['sharded_peak_gb']} / {row['unsharded_peak_gb']} GB; "
            f"{row['seconds']:.1f} s")
        reset_peak(torch, device)
    # (b)
    t0 = time.perf_counter()
    cfg = dataclasses.replace(configs.get(GRANITE17_ARCH), dtype="float32")
    big = mesh_mod.make_production_mesh(devices=devices)
    row, _ = sharded_serve_one(torch, np, mods, counters, cfg, big, GRANITE17_BATCH,
                               SERVE17_PROMPT, GRANITE17_NEW, GRANITE17_CACHE, device,
                               prompt_cache=True)
    if row["kv_mode"] != "seq" or any(row["launches"].values()) \
            or any(row["prefill_launches"].values()):
        fail(f"sharded serving {GRANITE17_ARCH} on (16, 16): kv_mode "
             f"{row['kv_mode']}, launches {row['launches']} (decode), "
             f"{row['prefill_launches']} (prefill)")
    row["seconds"] = time.perf_counter() - t0
    rec["granite_full"] = row
    say(f"sharded serving {GRANITE17_ARCH} whole (f32, production mesh (16, 16), "
        f"{GRANITE17_BATCH} rows, prompt {SERVE17_PROMPT} through "
        f"transformer.prefill, cache {GRANITE17_CACHE}, kv_mode seq): prefill "
        f"logits {row['prefill_max_abs_diff']:.3g} of max |logit| "
        f"{row['max_abs_logit']:.3g}; greedy tokens token for token; "
        f"{row['sharded_ms_per_decode_step']:.1f} ms a decode step sharded, "
        f"{row['unsharded_ms_per_decode_step']:.1f} unsharded; peak "
        f"{row['sharded_peak_gb']} / {row['unsharded_peak_gb']} GB; {row['seconds']:.1f} s")
    reset_peak(torch, device)
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"sharded serving phase: {rec['seconds']:.1f} s")
    return rec, entries


def _shard_bytes(tree) -> int:
    """Bytes of one shard's tensors (mesh position 0) of every
    ``ShardedTensor`` of ``tree``."""
    total = 0
    for _, leaf in _named_leaves(tree):
        if hasattr(leaf, "shard"):
            t = leaf.shard((0,) * leaf.mesh.devices.ndim)
            total += t.numel() * t.element_size()
    return total


def placed_state_bytes(torch, mods, cfg, mesh, kind, cache_spec=None, device="cuda"):
    """A shard's bytes of the state a phase placed on the card, summed over
    its tensors: the state drawn and placed on ``mesh`` again (train:
    params and moments; prefill: params; decode: params and cache), then
    freed."""
    api, sharding, train_loop, serve_loop = (mods["api"], mods["sharding"],
                                             mods["train_loop"], mods["serve_loop"])
    if kind == "train":
        state = train_loop.init_sharded_state(cfg, mesh, seed=0)
        n = _shard_bytes(state["params"]) + _shard_bytes(state["opt"])
    else:
        pshard = sharding.param_shardings(cfg, mesh, api.init_params(cfg, device="meta"))
        state = {"params": sharding.device_put(api.init_params(cfg, device=device, seed=0),
                                               pshard, donate=True)}
        if kind == "decode":
            real = api.init_cache(cfg, *cache_spec, device=device)
            plan, _ = serve_loop.compile_serve_step(cfg, mesh, real)
            state["cache"] = sharding.device_put(real, plan.cache_shardings, donate=True)
        n = _shard_bytes(state)
    del state
    sync(torch, device)
    return n


def dry_run_phase(torch, mods, record, smi, device="cuda"):
    """Phase 18: the dry run's account of the sharded steps phases 16 and
    17 ran (``record``'s), each on meta shards of the same mesh; its gates
    (argument bytes against the state placed on the card, K6 ops against
    the card's launches) and the achieved rate beside the card's peak.
    Returns the record."""
    import dataclasses
    configs, shapes, dryrun, mesh_mod, serve_loop = (
        mods["configs"], mods["shapes"], mods["dryrun"], mods["mesh"], mods["serve_loop"])
    t_phase = time.perf_counter()
    devices = None if torch.device(device).type == "cuda" else [device]
    meta = [torch.device("meta")]
    peaks = PEAK_FLOPS.get(torch.cuda.get_device_name(0) if devices is None else "", {})
    st16, sv17 = record["sharded_training"], record["sharded_serving"]
    rg = sv17["serve"][TRAIN_ARCH]
    full = st16["full"]
    train_shape = shapes.SHAPES["train_4k"]
    # (name, cfg, mesh shape, shape, the phase's measured s a step (None:
    # not measured, or only a cold first step: 16 (b) at FULL_STEPS = 1),
    # its peak GB, the card's K6 launches a step)
    full_s = full["sharded_step_s"]
    cases = [
        ("16 (a)", dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=TRAIN_LAYERS),
         SHARD_MESH, dataclasses.replace(train_shape, seq_len=TRAIN_SEQ,
                                         global_batch=TRAIN_BATCH),
         st16["train"]["sharded_ms_per_step"] / 1e3, st16["train"]["sharded_peak_gb"],
         st16["train"]["k6_launches"] / SHARD_STEPS),
        ("16 (b)", configs.get(FULL_ARCH), (16, 16),
         dataclasses.replace(train_shape, seq_len=FULL_SEQ, global_batch=FULL_BATCH),
         _steady_ms(full_s) / 1e3 if len(full_s) > 1 else None,
         full["sharded_peak_gb"], 0),
        ("17 (a) prefill", dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=3,
                                               dtype="float32"),
         SERVE_MESH, shapes.ShapeSpec("prefill", "prefill", SERVE17_PROMPT, SERVE17_BATCH),
         None, rg["sharded_peak_gb"], rg["k6_prefill_launches"]),
        ("17 (a) decode", dataclasses.replace(configs.get(TRAIN_ARCH), n_layers=3,
                                              dtype="float32"),
         SERVE_MESH, shapes.ShapeSpec("decode", "decode", SERVE17_PROMPT + SERVE17_NEW,
                                      SERVE17_BATCH),
         rg["sharded_ms_per_decode_step"] / 1e3, rg["sharded_peak_gb"],
         rg["k6_decode_launches"] / rg["decode_steps"]),
        ("17 (b) decode", dataclasses.replace(configs.get(GRANITE17_ARCH), dtype="float32"),
         (16, 16), shapes.ShapeSpec("decode", "decode", GRANITE17_CACHE, GRANITE17_BATCH),
         sv17["granite_full"]["sharded_ms_per_decode_step"] / 1e3,
         sv17["granite_full"]["sharded_peak_gb"], 0),
    ]
    rec = {"nvidia_smi": smi, "cells": {}}
    for name, cfg, mshape, shape, step_s, peak, k6 in cases:
        t0 = time.perf_counter()
        over = {}
        if shape.kind == "train":
            over["n_microbatches"] = 1
        mmesh = mesh_mod.make_mesh(mshape, ("data", "model"), meta)
        acct, info, _, _ = dryrun.account_cell(cfg, shape, False, over, mesh=mmesh)
        account_s = time.perf_counter() - t0
        args = info["arguments"]
        state = args.get("state", 0) + args.get("params", 0) + args.get("cache", 0)
        cmesh = mesh_mod.make_mesh(mshape, ("data", "model"), devices)
        cache = (shape.global_batch, mods["api"].decode_cache_len(cfg, shape.seq_len)) \
            if shape.kind == "decode" else None
        placed = placed_state_bytes(torch, mods, cfg, cmesh, shape.kind, cache, device)
        if placed != state:
            fail(f"dry run {name} ({cfg.name}): a shard's state in the account "
                 f"{state} bytes, placed on the card {placed}")
        got_k6 = acct.kernels.get("causal_conv1d", 0)
        if got_k6 != k6:
            fail(f"dry run {name} ({cfg.name}): {got_k6} K6 ops a step in the "
                 f"account, the card launched {k6} a step")
        pd, ex = acct.per_device, acct.executed
        mem = info["memory"]
        peak_rate = peaks.get(cfg.dtype)
        tflops = ex.total_flops / step_s / 1e12 if step_s else None
        row = {"arch": cfg.name, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
               "mesh": list(mshape), "kind": shape.kind, "batch": shape.global_batch,
               "seq": shape.seq_len, "account_s": account_s,
               "flops_per_device": pd.total_flops, "dot_flops_per_device": pd.dot_flops,
               "flops_executed": ex.total_flops, "dot_flops_executed": ex.dot_flops,
               "hbm_bytes_per_device": pd.hbm_bytes, "hbm_bytes_executed": ex.hbm_bytes,
               "collective_bytes_per_device": pd.collective_bytes,
               "collective_bytes_executed": ex.collective_bytes,
               "memory_per_device": mem, "temp_bytes_executed": acct.executed_temp_bytes,
               "held_bytes_executed": info["held_bytes"],
               "predicted_peak_gb": (info["held_bytes"] + acct.executed_temp_bytes) / 1e9,
               "argument_bytes_per_shard": args, "placed_state_bytes_per_shard": placed,
               "k6_ops": got_k6, "k6_launches_on_card": k6,
               "measured_s_per_step": step_s, "measured_peak_gb": peak,
               "achieved_tflops": tflops,
               "peak_share": tflops * 1e12 / peak_rate if tflops and peak_rate else None}
        rec["cells"][name] = row
        rate = (f"{tflops:.2f} TFLOP/s achieved ({row['peak_share']:.2%} of "
                f"{peak_rate / 1e12:g} {cfg.dtype})" if tflops and peak_rate else
                f"{tflops:.2f} TFLOP/s achieved" if tflops else
                "no steady step measured (none, or a cold first step only)")
        say(f"dry run {name} ({cfg.name} {cfg.n_layers} layers, {cfg.dtype}, {shape.kind} "
            f"{shape.global_batch} x {shape.seq_len}, meta mesh {mshape}; {smi}): "
            f"{pd.total_flops:.6g} FLOPs a step a device ({pd.dot_flops:.6g} dot), "
            f"{ex.total_flops:.6g} executed; {rate}; HBM bytes {pd.hbm_bytes:.6g} a "
            f"device, {ex.hbm_bytes:.6g} executed; collective bytes {pd.collective_bytes:.6g} "
            f"a device {dict(pd.coll_counts)}; memory a device {mem['per_device_total_bytes'] / 1e9:.3f} GB "
            f"(arguments {mem['argument_size_in_bytes'] / 1e9:.3f}, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.3f}); one process holds "
            f"{row['predicted_peak_gb']:.3f} GB at its peak (arguments "
            f"{info['held_bytes'] / 1e9:.3f}, temp {acct.executed_temp_bytes / 1e9:.3f}) "
            f"beside the measured peak {peak} GB; "
            f"state a shard {state} bytes = placed on the card; K6 {got_k6} ops a step "
            f"= the card's {k6:g}; accounted in {account_s:.1f} s")
    rec["seconds"] = time.perf_counter() - t_phase
    say(f"dry run phase: {rec['seconds']:.1f} s")
    return rec


class PhaseClock:
    """Wall seconds a phase: ``next(name)`` closes the running phase
    (printing ``phase <name>: <s> s``) and opens ``name``; ``stop()``
    closes the last.  The seconds go into ``record["phase_seconds"]``."""

    def __init__(self, record: dict):
        self.seconds = record.setdefault("phase_seconds", {})
        self.name, self.t0 = None, time.perf_counter()

    def next(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            self.seconds[self.name] = now - self.t0
            say(f"phase {self.name}: {now - self.t0:.1f} s")
        self.name, self.t0 = name, now

    def stop(self) -> None:
        self.next(None)

    def table(self) -> None:
        say("| phase | seconds |")
        say("|---|---|")
        for name, sec in self.seconds.items():
            say(f"| {name} | {sec:.1f} |")
        say(f"| all phases | {sum(self.seconds.values()):.1f} |")


# phase 19: the examples of examples/torch_port through main([...]): (label,
# script, argv, {kernel: (fewest, most launches)}, most None: no bound;
# every kernel not named must stay 0).  fwi's full mode runs its forward
# 1 + 120 times and replays each backward pass's windows on the same
# kernel: at least 60 x 121 K1 launches.  train_lm's 100m preset runs 150
# of its 300 steps: its 300 took 39-55 s, and the whole script passed
# 1000 s with them on slower hosts
EXAMPLES_DIR = ROOT / "examples" / "torch_port"
EXAMPLE_RUNS = (
    ("quickstart", "quickstart", [], {"map_step": (50, 50), "fused_step": (50, 50)}),
    ("acoustic 512^3 gmem", "acoustic_iso_3d",
     ["--shape", "512", "512", "512", "--iters", "100", "--template", "gmem"],
     {"map_step": (100, 100)}),
    ("acoustic 512^3 shift --fuse 10", "acoustic_iso_3d",
     ["--shape", "512", "512", "512", "--iters", "100", "--template", "shift",
      "--fuse", "10"], {"stream_step": (100, 100)}),
    ("acoustic --distributed", "acoustic_iso_3d", ["--distributed"], {}),
    ("acoustic --distributed --template gmem", "acoustic_iso_3d",
     ["--distributed", "--template", "gmem"], {"map_step": (1, None)}),
    ("fwi --template gmem", "fwi", ["--template", "gmem"],
     {"fused_step": (60 * 121, None)}),
    ("fwi --smoke --mesh 4", "fwi", ["--smoke", "--mesh", "4"], {}),
    ("serve_lm", "serve_lm", [], {"causal_conv1d": (1, None)}),
    ("train_lm --preset 100m --steps 150", "train_lm",
     ["--preset", "100m", "--steps", "150"], {}),
    ("train_lm --preset smoke --ckpt-dir", "train_lm", ["--preset", "smoke"], {}),
)
# the kernels a phase 19 row reports (K3, K5 and K7 are off these paths:
# they must stay 0 too)
EXAMPLE_KERNELS = {"K1": "fused_step", "K2": "stream_step", "K4": "map_step",
                   "K6": "causal_conv1d"}
# phase 19 holds the kernels its examples run at their own sources and
# shapes against st.torch() on the card: each pair's wavefields (the
# kernel's run, then the torch run: max |diff| within the field gate,
# EXAMPLE_FIELD_TOL of the torch field's max; energy and max |p| within
# EXAMPLE_REL_TOL relative); and fwi's full-mode problem (FWI_N² x
# FWI_STEPS) under K1: its observed data within the field gate, its first
# misfit within EXAMPLE_REL_TOL relative and its gradient within
# FWI_GRAD_TOL of the gradient's max (tests/test_torch_examples.py's
# limits against the JAX package)
EXAMPLE_PAIRS = (("acoustic --distributed --template gmem", "acoustic --distributed"),)
EXAMPLE_FIELD_TOL, EXAMPLE_REL_TOL, FWI_GRAD_TOL = 2e-5, 1e-5, 5e-4
FWI_N, FWI_STEPS = 48, 60


def load_example(name: str):
    """``examples/torch_port/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"torch_port_{name}",
                                                  EXAMPLES_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_sources(torch, st, codegen) -> list:
    """The sources of phase 19's fused K1 runs (quickstart's star2d4r at
    256², fwi's wave at 48²), for phase 2's parallel build."""
    q, f = load_example("quickstart"), load_example("fwi")
    out = []
    for k, shape, swap in ((q.kernel_star2d4r, q.SHAPE, ("v", "u")),
                           (f.wave2d, (FWI_N, FWI_N), ("p0", "p1"))):
        halos = {g: (k.info.order,) * 2 for g in k.ir.grid_params}
        out.append(codegen.plan_cuda(k.ir, halos, shape, st.hopper(),
                                     swap=swap).source(torch.float32))
    return out


def _numbers(x):
    """The JSON-able numbers of an example's result (tensors and arrays
    dropped)."""
    if isinstance(x, dict):
        out = {str(k): _numbers(v) for k, v in x.items()}
        return {k: v for k, v in out.items() if v is not None}
    if isinstance(x, (list, tuple)):
        out = [_numbers(v) for v in x]
        return out if all(v is not None for v in out) else None
    if isinstance(x, bool) or x is None:
        return x
    if isinstance(x, (int, float, str)):
        return x
    return None


def _field_diff(torch, label, got, want):
    """``got``'s wavefield against ``want``'s (both an example's result):
    fails past the field gate or the relative gates.  Returns the row."""
    a, b = got["field"].double(), want["field"].double()
    scale = float(b.abs().max())
    err = float((a - b).abs().max())
    rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("energy", "max_abs_p")}
    if (not bool(torch.isfinite(a).all()) or err > EXAMPLE_FIELD_TOL * scale
            or max(rel.values()) > EXAMPLE_REL_TOL):
        fail(f"example {label}: max |diff| {err} of max |p| {scale} (limit "
             f"{EXAMPLE_FIELD_TOL}), relative {rel} (limit {EXAMPLE_REL_TOL})")
    return {"max_abs_diff": err, "max_abs_field": scale,
            **{f"{k}_rel_diff": v for k, v in rel.items()}}


def fwi_check(torch, st, counters, device):
    """fwi's full-mode problem (``FWI_N``² x ``FWI_STEPS``, the source
    phase 2 built) under K1 against ``st.torch()`` on ``device``: the
    observed data, the first misfit and its gradient.  K1 must launch in
    the K1 run and not in the torch run.  Returns the row."""
    reset_counts, counts = counters
    f = load_example("fwi")
    got = {}
    for name, backend in (("torch", st.torch()), ("K1", st.hopper(template="gmem"))):
        reset_counts()
        _, d_obs, misfit = f.make_problem(FWI_N, FWI_STEPS, device, backend)
        v = torch.full((FWI_N, FWI_N), 1.0, device=device, requires_grad=True)
        loss = misfit(v)
        (g,) = torch.autograd.grad(loss, v)
        got[name] = (d_obs, float(loss.detach()), g.detach().double(),
                     counts()["fused_step"])
    (obs_t, loss_t, g_t, n_t), (obs_k, loss_k, g_k, n_k) = got["torch"], got["K1"]
    scale = max(float(obs_t[g].abs().max()) for g in obs_t)
    obs_err = max(float((obs_k[g].double() - obs_t[g].double()).abs().max())
                  for g in obs_t)
    loss_rel = abs(loss_k - loss_t) / abs(loss_t)
    g_scale = float(g_t.abs().max())
    g_err = float((g_k - g_t).abs().max())
    row = {"n": FWI_N, "steps": FWI_STEPS, "observed_max_abs_diff": obs_err,
           "observed_max_abs": scale, "misfit_torch": loss_t, "misfit_k1": loss_k,
           "misfit_rel_diff": loss_rel, "grad_max_abs_diff": g_err,
           "grad_max_abs": g_scale, "k1_launches": n_k}
    if n_t or n_k < 2 * FWI_STEPS:
        fail(f"fwi check: K1 launched {n_k} times under st.hopper (at least "
             f"{2 * FWI_STEPS}: the observed data and the misfit's forward) and "
             f"{n_t} under st.torch() (expected 0)")
    if (obs_err > EXAMPLE_FIELD_TOL * scale or loss_rel > EXAMPLE_REL_TOL
            or not math.isfinite(g_err) or g_err > FWI_GRAD_TOL * g_scale):
        fail(f"fwi check: K1 against st.torch() {row} (limits: data "
             f"{EXAMPLE_FIELD_TOL} of max, misfit {EXAMPLE_REL_TOL} relative, "
             f"gradient {FWI_GRAD_TOL} of max)")
    return row


def examples_phase(torch, st, counters, smi, device="cuda"):
    """Phase 19: each of ``EXAMPLE_RUNS`` through its script's ``main``
    on ``device``; the counts set to 0 just before a run and read just
    after, each within its run's bounds; then ``EXAMPLE_PAIRS``' fields
    and ``fwi_check``.  Returns the record."""
    reset_counts, counts = counters
    rec = {"runs": [], "pairs": {}}
    keep = {lab for pair in EXAMPLE_PAIRS for lab in pair}
    fields = {}
    tmp = CKPT_ROOT / "examples"
    for label, script, argv, want in EXAMPLE_RUNS:
        mod = load_example(script)
        args = ["--device", str(device), *argv]
        if "--ckpt-dir" in label:
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir(parents=True)
            args += ["--ckpt-dir", str(tmp)]
        say(f"example {label}: python examples/torch_port/{script}.py "
            f"{' '.join(args)}")
        reset_counts()
        t0 = time.perf_counter()
        try:
            out = mod.main(args)
        except AssertionError as e:
            fail(f"example {label}: {e}")
        finally:
            if "--ckpt-dir" in label:
                shutil.rmtree(tmp, ignore_errors=True)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        seen = counts()
        for kname, n in seen.items():
            lo, hi = want.get(kname, (0, 0))
            if n < lo or (hi is not None and n > hi):
                fail(f"example {label}: {n} launches of {kname}, expected "
                     f"{lo} to {hi if hi is not None else 'any'} ({seen})")
        row = {"example": label, "script": script, "argv": args,
               "seconds": seconds, "launches": seen, "result": _numbers(out)}
        rec["runs"].append(row)
        say(f"example {label}: OK in {seconds:.1f} s; launches "
            + ", ".join(f"{k} {seen[v]}" for k, v in EXAMPLE_KERNELS.items())
            + f"; {smi}")
        if label in keep:
            fields[label] = out
        del mod, out
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for got, want in EXAMPLE_PAIRS:
        row = _field_diff(torch, got, fields[got], fields[want])
        rec["pairs"][f"{got} vs {want}"] = row
        say(f"example {got} against {want}: max |diff| {row['max_abs_diff']:.4g} of "
            f"max |p| {row['max_abs_field']:.6g} (limit {EXAMPLE_FIELD_TOL}), energy "
            f"{row['energy_rel_diff']:.3g} and max |p| {row['max_abs_p_rel_diff']:.3g} "
            f"relative (limit {EXAMPLE_REL_TOL}); {smi}")
    del fields
    rec["fwi_check"] = row = fwi_check(torch, st, counters, device)
    say(f"fwi check ({FWI_N}² x {FWI_STEPS} steps, K1 against st.torch()): observed "
        f"data max |diff| {row['observed_max_abs_diff']:.4g} of {row['observed_max_abs']:.6g}"
        f" (limit {EXAMPLE_FIELD_TOL}), first misfit {row['misfit_k1']!r} against "
        f"{row['misfit_torch']!r} ({row['misfit_rel_diff']:.3g} relative, limit "
        f"{EXAMPLE_REL_TOL}), gradient max |diff| {row['grad_max_abs_diff']:.4g} of "
        f"{row['grad_max_abs']:.6g} (limit {FWI_GRAD_TOL}); K1 {row['k1_launches']} "
        f"launches (not counted on the path); {smi}")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-3 at the small shapes only, no result line")
    ap.add_argument("--json", help="also write every number to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import acoustic, regions, suite
        from repro_torch.core import adjoint, autotune, cost_model
        from repro_torch.core import distributed
        from repro_torch.core import dsl as st
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch import sharding
        from repro_torch.core import timeloop
        from repro_torch.kernels import _build
        from repro_torch.kernels.stencil import codegen
        from repro_torch.kernels.stencil.fused_step import (fused_step,
                                                           fused_step_plain)
        from repro_torch.kernels.stencil.map_step import (map_step,
                                                         map_step_plain)
        from repro_torch.kernels.stencil.semi_step import (semi_step,
                                                          semi_step_plain)
        from repro_torch.kernels.stencil.stream_step import (stream_step,
                                                            stream_step_plain)
        from repro_torch.kernels.stencil.temporal_step import (
            temporal_step, temporal_step_plain)
        from repro_torch import configs
        from repro_torch.configs import shapes as lm_shapes
        from repro_torch.kernels.conv1d import conv1d as conv
        from repro_torch.kernels.conv1d import ops as conv_ops
        from repro_torch.kernels.conv1d import ref as conv_ref
        from repro_torch.kernels.decode_attn import decode_attn as attn
        from repro_torch.kernels.decode_attn import ref as attn_ref
        from repro_torch.models import api, encdec, griffin, transformer
        from repro_torch.models import layers as lm_layers
        from repro_torch.launch import dryrun
        from repro_torch.launch import train as train_cli
        from repro_torch.serving import serve_loop, stencil_serve
        from repro_torch.train import checkpoint, fault_tolerance
        from repro_torch.train import data as train_data
        from repro_torch.train import optimizer, train_loop
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    wrappers = {"fused_step": (fused_step, fused_step_plain),
                "stream_step": (stream_step, stream_step_plain),
                "temporal_step": (temporal_step, temporal_step_plain),
                "semi_step": (semi_step, semi_step_plain),
                "map_step": (map_step, map_step_plain)}

    # K7's entries count its two kernels' launches (split, combine)
    lm_wrappers = {"causal_conv1d": conv.causal_conv1d_cuda,
                   "decode_attention": attn.split_cuda,
                   "decode_attention.combine": attn.combine_cuda}

    def reset_counts():
        for kern, _ in wrappers.values():
            kern.launches = 0
        for kern in lm_wrappers.values():
            kern.launches = 0

    def counts():
        seen = {kname: kern.launches for kname, (kern, _) in wrappers.items()}
        seen.update({k: kern.launches for k, kern in lm_wrappers.items()})
        return seen

    record = {"phases": {}}
    clock = PhaseClock(record)

    # -- 1. environment ------------------------------------------------------
    clock.next("1 environment")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    say(smi)
    card = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    say(f"device: {card}, compute capability {cc[0]}.{cc[1]}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cc[0] != 9:
        fail(f"compute capability {cc} is not 9.x: the kernels target sm_90a")
    rates = CARD_RATES.get(card)
    if rates is None:
        say(f"bounds: no data-sheet rates for {card!r}; bound_ms is null")
    else:
        say(f"bounds: {rates[0] / 1e12} TB/s, {rates[1] / 1e12} TFLOP/s f32")
    record["device"] = {"name": card, "nvidia_smi": smi,
                        "capability": list(cc)}

    mods = {"st": st, "suite": suite, "acoustic": acoustic}
    workloads = [Workload("star3d4r", mods), Workload("acoustic_iso", mods)]
    jacobi3d, listing1_kernel = extra_kernels(st)
    jacobi = Workload("jacobi3d", mods, kernel=jacobi3d)

    # -- 2. build ------------------------------------------------------------
    clock.next("2 build")
    shapes = SMALL_SHAPES if args.quick else SMALL_SHAPES + (MAIN_SHAPE,)
    t0 = time.perf_counter()
    # K2's and K3's sources depend on the buffers' pitches (their staging
    # path): one for every shape, depth and type phase 3 runs them at
    fused_builds = [(w, kname, shape, k, dtype)
                    for w in workloads for kname in KERNELS
                    for shape in shapes for k in fused_depths(kname, shape)
                    for dtype in (torch.float32, torch.bfloat16)
                    if dtype == torch.float32 or shape != MAIN_SHAPE
                    or kname in BF16_TIMED]
    sources = [w.plan(codegen, shape, KERNELS[kname][0], k).source(dtype)
               for w, kname, shape, k, dtype in fused_builds]
    # K2's fork at 512³: the same kernels with granules in place of the TMA
    forks = ([] if args.quick else
             [(w, dtype) for w in workloads
              for dtype in (torch.float32, torch.bfloat16)])
    sources += [granule_plan(w.plan(codegen, MAIN_SHAPE, "shift")).source(dtype)
                for w, dtype in forks]
    # a map plan's source depends on the grids' pitches and the region
    # (f4's load paths, smem's staging paths): one for every case run below
    map_builds = [(w, t, shape, region, dtype)
                  for w in workloads + [jacobi] for _, t in MAP_KERNELS.values()
                  for shape, region in map_cases(w, jacobi, shapes)
                  for dtype in ((torch.float32,) if w is jacobi
                                else map_dtypes(torch, t, shape, region))]
    sources += [w.map_plan(codegen, shape, t, region).source(dtype)
                for w, t, shape, region, dtype in map_builds]
    # phase 7's seven regions under f4 (each region's first cell has its
    # place in an aligned vector of 4)
    sources += [codegen.lower_hopper(
        workloads[0].kernel.ir, {g: (4,) * 3 for g in ("u", "v")}, MAIN_SHAPE,
        r, st.hopper(template="f4")).source()
        for r in regions.seven_region(MAIN_SHAPE, PML_WIDTH)]
    sources += [codegen.lower_hopper(
        listing1_kernel.ir, {"u": (4, 4), "v": (4, 4)}, LISTING1_SHAPE, None,
        st.cuda(computeCapability="9.0", threadsPerBlock=(8, 128),
                template="gmem")).source()]
    sources += [conv.source(), attn.source()]
    # phase 13 runs its first request under K2 at the request's own shape;
    # phase 19 K1 on two 2D grids
    if not args.quick:
        sources.append(workloads[0].plan(codegen, sim_requests(np)[0][0],
                                         "shift").source(torch.float32))
        sources += example_sources(torch, st, codegen)
    try:
        _build.build_many(sources)
    except RuntimeError as e:
        fail(f"build: {e}")
    build_s = time.perf_counter() - t0
    sources = list(dict.fromkeys(sources))
    say(f"build: {len(sources)} kernels in {build_s:.1f} s")
    for src in sources:
        for line in _build.ptxas_log(src).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas: {line.strip()}")
    record["phases"]["build_s"] = build_s
    # the load (f4) or staging (smem) path of every f4/smem build, with its
    # registers and spills
    record["paths"] = []
    paths = [(w.map_plan(codegen, shape, t, region), w.name, shape, region,
              dtype) for w, t, shape, region, dtype in map_builds
             if t in ("gmem", "f4", "smem", "shift")]
    paths += [(w.plan(codegen, shape, KERNELS[kname][0], k), w.name, shape,
               None, dtype) for w, kname, shape, k, dtype in fused_builds
              if kname in ("fused_step", "stream_step", "temporal_step")]
    for plan, wname, shape, region, dtype in paths:
        entry = {"map": "map_step", "fused": "fused_step", "stream": "stream_step",
                 "temporal": "temporal_step"}[plan.kind]
        name = (f"{entry}.{plan.template}" if plan.kind == "map" else
                f"{entry}{'.map' if hasattr(plan, 'region') else ''}"
                f"{f' k={plan.time_block}' if plan.time_block > 1 else ''}")
        row = {"kernel": f"{name}[{wname}]", "shape": list(shape),
               "region": region, "dtype": str(dtype).split(".")[1],
               "block": list(plan.B), **path_of(plan, dtype),
               **ptxas_usage(_build.ptxas_log(plan.source(dtype)),
                             f"{'map_step' if plan.kind == 'fused' else entry}_kernel")}
        record["paths"].append(row)
        smem = row.get("smem_bytes")
        say(f"path {row['kernel']} {row['dtype']} at {shape} region {region}: "
            f"{row['path']}, block {plan.B}"
            f"{f', {smem} B shared' if smem else ''}; ptxas {row['registers']} "
            f"registers, {row['spill_stores']} B spill stores, "
            f"{row['spill_loads']} B spill loads")

    # -- 3. kernels vs plain versions ----------------------------------------
    clock.next("3 kernels")
    entries = {}
    library = {}        # workload -> ms of its one library call, or None
    for w in workloads:
        for kname, (template, k_main) in KERNELS.items():
            kern, plain = wrappers[kname]
            key = f"{kname}[{w.name}]"
            worst = 0.0
            for shape in shapes:
                for k in fused_depths(kname, shape):
                    plan = w.plan(codegen, shape, template, k)
                    got, ref, run_kern, run_plain = one_launch(
                        torch, kname, kern, plain, plan,
                        w.arrays(torch, shape, seed=1), w.scalars)
                    err = check_out(torch, f"{key} k={k} at {shape}",
                                    {g: got[g] for g in plan.step_out_grids},
                                    {g: ref[g] for g in plan.step_out_grids},
                                    rel_tol)
                    worst = max(worst, err)
                    say(f"kernel {key} k={k} {shape}: max abs err {err:.3g}")
                    if shape == MAIN_SHAPE:
                        ms = time_ms(torch, run_kern, 50, 10) / k
                        plain_ms = time_ms(
                            torch, run_plain,
                            5 if kname == "fused_step" else 1) / k
                        if w.name not in library:
                            library[w.name] = None
                            if w.name == "star3d4r":
                                lib_ms, lib_err = star_conv(torch, w, codegen,
                                                            fused_step_plain,
                                                            ref)
                                library[w.name] = lib_ms
                                say(f"library conv3d[star3d4r] {shape}: "
                                    f"{lib_ms:.4f} ms, max abs err vs plain "
                                    f"{lib_err:.3g}")
                        info = w.kernel.info
                        n = np.prod(shape, dtype=np.float64)
                        # compulsory traffic: each input read once and each
                        # buffer the launch writes written once, per k steps
                        nbytes = 4 * n * (len(info.input_grids)
                                          + len(plan.step_out_grids)) / k
                        bound, bound_by = bound_of(
                            rates, nbytes, info.flops_per_point * n)
                        lib = (library[w.name] if kname != "temporal_step"
                               else None)   # no one call does k steps
                        entries[key] = {
                            "name": key, "route": "cuda",
                            "source": "src/repro_torch/kernels/stencil/csrc/"
                                      + plan.source_file,
                            "replaces": REPLACES[kname], "launches": None,
                            "max_abs_err": None, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound,
                            "bound_by": bound_by, "library_ms": lib,
                            "time_block": k, "launch_ms": ms * k,
                            "modeled_bytes_per_step": plan.hbm_bytes_per_step()}
                        say(f"time {key} {shape}: {ms:.4f} ms/step, "
                            f"{ms * k:.4f} ms/launch (plain {plain_ms:.2f} "
                            f"ms, bound {bound} ms, library {lib} ms)")
                    del plan, got, ref, run_kern, run_plain
                    torch.cuda.empty_cache()
            if key in entries:
                entries[key]["max_abs_err"] = worst

    # the per-application kernels: the workloads at every shape and at a
    # sub-region of the ragged one; the Jacobi kernel (outputs into a
    # destination) at the ragged shape and the sub-region
    for w in workloads + [jacobi]:
        for ename, (wname, template) in MAP_KERNELS.items():
            kern, plain = wrappers[wname]
            key = f"{ename}[{w.name}]"
            worst = 0.0
            for shape, region in map_cases(w, jacobi, shapes):
                plan = w.map_plan(codegen, shape, template, region)
                if plan.in_place == (w is jacobi):
                    fail(f"{key}: in_place is {plan.in_place}")
                err, run_kern, run_plain = one_map(
                    torch, f"{key} at {shape} region {region}", kern, plain,
                    plan, w.arrays(torch, shape, seed=2), w.scalars)
                worst = max(worst, err)
                say(f"kernel {key} {shape} region {region}: max abs err "
                    f"{err:.3g}")
                if shape == MAIN_SHAPE:
                    ms = time_ms(torch, run_kern, 50, 10)
                    plain_ms = time_ms(torch, run_plain, 1)
                    info = w.kernel.info
                    n = np.prod(shape, dtype=np.float64)
                    bound, bound_by = bound_of(
                        rates, 4 * n * (len(info.input_grids)
                                        + len(info.output_grids)),
                        info.flops_per_point * n)
                    entries[key] = {
                        "name": key, "route": "cuda",
                        "source": "src/repro_torch/kernels/stencil/csrc/"
                                  + plan.source_file,
                        "replaces": REPLACES[ename], "launches": None,
                        "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library.get(w.name),
                        "template": template,
                        "modeled_bytes_per_step": plan.hbm_bytes_per_step()}
                    say(f"time {key} {shape}: {ms:.4f} ms/application "
                        f"(plain {plain_ms:.2f} ms, bound {bound} ms, "
                        f"library {library.get(w.name)} ms)")
                del plan, run_kern, run_plain
                torch.cuda.empty_cache()
            if key in entries:
                entries[key]["max_abs_err"] = worst
    # bf16 grids: every stencil source (K3 at k=2) against its plain
    # version at the small shapes; K1 and K2 also at 512³, timed
    bf16_rows = []
    bf16 = torch.bfloat16
    library_bf16 = {}   # workload -> ms of conv3d on bf16 grids
    for w in workloads:
        for kname, (template, _) in KERNELS.items():
            kern, plain = wrappers[kname]
            timed = kname in BF16_TIMED and not args.quick
            for shape, k in [(shape, k) for shape in SMALL_SHAPES + (
                    (MAIN_SHAPE,) if timed else ())
                    for k in fused_depths(kname, shape)]:
                key = f"{kname}[{w.name}] bf16 k={k} {shape}"
                plan = w.plan(codegen, shape, template, k)
                got, ref, run_kern, run_plain = one_launch(
                    torch, kname, kern, plain, plan,
                    w.arrays(torch, shape, seed=4, dtype=bf16), w.scalars)
                err = check_out(torch, key,
                                {g: got[g] for g in plan.step_out_grids},
                                {g: ref[g] for g in plan.step_out_grids},
                                bf16_ulp)
                row = {"case": key, "max_abs_err": err}
                msg = f"kernel {key}: max abs err {err:.3g}"
                if shape == MAIN_SHAPE:
                    n = np.prod(shape, dtype=np.float64)
                    info = w.kernel.info
                    bound, bound_by = bound_of(
                        rates, 2 * n * (len(info.input_grids)
                                        + len(plan.step_out_grids)) / k,
                        info.flops_per_point * n)
                    if w.name == "star3d4r" and w.name not in library_bf16:
                        lib_ms, lib_err = star_conv(torch, w, codegen,
                                                    fused_step_plain, ref)
                        library_bf16[w.name] = lib_ms
                        say(f"library conv3d[star3d4r] bf16 {shape}: "
                            f"{lib_ms:.4f} ms, max abs err vs plain "
                            f"{lib_err:.3g}")
                    launch = time_ms(torch, run_kern, 50, 10)
                    row.update(ms=launch / k, launch_ms=launch, time_block=k,
                               plain_ms=time_ms(torch, run_plain, 1) / k,
                               bound_ms=bound, bound_by=bound_by,
                               library_ms=(library_bf16.get(w.name)
                                           if k == 1 else None),
                               modeled_bytes_per_step=plan.hbm_bytes_per_step(2))
                    msg += (f"; {row['ms']:.4f} ms/step (plain "
                            f"{row['plain_ms']:.2f} ms, bound {bound} ms, "
                            f"library {row['library_ms']} ms)")
                bf16_rows.append(row)
                say(msg)
                del plan, got, ref, run_kern, run_plain
                torch.cuda.empty_cache()
        for ename, (wname, template) in MAP_KERNELS.items():
            kern, plain = wrappers[wname]
            for shape, region in map_cases(w, jacobi, shapes):
                if bf16 not in map_dtypes(torch, template, shape, region):
                    continue
                key = f"{ename}[{w.name}] bf16 {shape} region {region}"
                plan = w.map_plan(codegen, shape, template, region)
                err, run_kern, run_plain = one_map(
                    torch, key, kern, plain, plan,
                    w.arrays(torch, shape, seed=5, dtype=bf16), w.scalars,
                    bf16_ulp)
                row = {"case": key, "max_abs_err": err}
                msg = f"kernel {key}: max abs err {err:.3g}"
                if shape == MAIN_SHAPE:
                    n = np.prod(shape, dtype=np.float64)
                    info = w.kernel.info
                    bound, bound_by = bound_of(
                        rates, 2 * n * (len(info.input_grids)
                                        + len(info.output_grids)),
                        info.flops_per_point * n)
                    row.update(ms=time_ms(torch, run_kern, 50, 10),
                               plain_ms=time_ms(torch, run_plain, 1),
                               bound_ms=bound, bound_by=bound_by,
                               library_ms=library_bf16.get(w.name),
                               modeled_bytes_per_step=plan.hbm_bytes_per_step(2))
                    msg += (f"; {row['ms']:.4f} ms/application (plain "
                            f"{row['plain_ms']:.2f} ms, bound {bound} ms, "
                            f"library {row['library_ms']} ms)")
                bf16_rows.append(row)
                say(msg)
                del plan, run_kern, run_plain
                torch.cuda.empty_cache()
    record["bf16"] = bf16_rows
    record["stream_forks"] = stream_forks(torch, codegen, stream_step, forks)
    conv_entries, conv_rows, conv_worst = conv_phase(torch, rates, conv,
                                                     conv_ref, args.quick)
    attn_entries, attn_rows = attn_phase(torch, rates, attn, attn_ref,
                                         args.quick)
    record["lm_kernels"] = conv_rows + attn_rows
    if not args.quick:
        record["conv_backward"] = conv_backward_phase(torch, rates, conv,
                                                      conv_ops, conv_ref)
    if args.quick:
        say("quick: phases 1-3 passed")
        return 0

    # -- 4. main path ----------------------------------------------------------
    clock.next("4 main path")
    main_rows = []

    def star_run(backend, grids):
        k = suite.get_kernel("star3d4r")

        @st.target
        def run(u, v):
            return st.timeloop(STEPS, swap=("v", "u"))(k)(u, v)
        return st.launch(backend=backend)(run)(grids["u"], grids["v"]).value

    def acoustic_run(backend, fields, fuse=ACOUSTIC_FUSE):
        p0, p1, vp2, damp, dt = fields
        acoustic.inject_source(p1, 0)

        def between(t, grids):
            acoustic.inject_source(grids["p1"], t)
        return st.launch(backend=backend, fuse_steps=fuse)(
            acoustic.acoustic_target_fused)(p0, p1, vp2, damp, dt, STEPS,
                                            between=between).value

    def hopper(kname):
        template, k = KERNELS[kname]
        return st.hopper(template=template, time_block=k)

    for w in workloads:
        if w.name == "star3d4r":
            init = suite.make_grids("star3d4r", MAIN_SHAPE, seed=0)
            fresh = lambda: {g: x.copy() for g, x in init.items()}  # noqa: E731
            run = star_run
        else:
            init = acoustic.make_fields(MAIN_SHAPE, pml_width=10)
            fresh = lambda: tuple(x.copy() for x in init[:4]) + (init[4],)  # noqa: E731
            run = acoustic_run
        ref_fields = fresh()
        t0 = time.perf_counter()
        run(st.torch(), ref_fields)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref = (ref_fields if isinstance(ref_fields, dict)
               else dict(zip(("p0", "p1"), ref_fields[:2])))
        for kname, (template, k) in KERNELS.items():
            key = f"{kname}[{w.name}]"
            fields = fresh()
            reset_counts()
            res = run(hopper(kname), fields)
            seen = counts()
            got = (fields if isinstance(fields, dict)
                   else dict(zip(("p0", "p1"), fields[:2])))
            if seen[kname] != STEPS // k or sum(seen.values()) != STEPS // k:
                fail(f"{key}: launch counts {seen}, expected {STEPS // k} "
                     f"of {kname} and no other")
            entries[key]["launches"] = seen[kname]
            diff, scale = max_diff(torch, key, got, ref)
            if kname == "fused_step" and w.name == "acoustic_iso":
                # K1 on the fields after the main path's 100 steps (a wave
                # around the source, zero elsewhere) beside phase 3's random
                # fields: the share of the division's slow path
                plan = w.plan(codegen, MAIN_SHAPE, template)
                padded = plan.to_padded({g: f.data.clone() for g, f in zip(
                    w.kernel.ir.grid_params, fields[:4])})
                ms_fields = time_ms(torch, lambda: fused_step(plan, padded, w.scalars),
                                    50, 10)
                entries[key]["ms_main_path_fields"] = ms_fields
                say(f"time {key} {MAIN_SHAPE} on the main path's fields after {STEPS} "
                    f"steps: {ms_fields:.4f} ms/step (random fields "
                    f"{entries[key]['ms']:.4f} ms)")
                del plan, padded
            n = float(np.prod(MAIN_SHAPE))
            steps_s = STEPS / res.seconds
            nbytes = 4 * n * (len(w.kernel.info.input_grids)
                              + len(w.kernel.info.output_grids))
            row = {"path": key, "template": template, "time_block": k,
                   "steps": STEPS, "fuse_steps": res.fuse_steps,
                   "seconds": res.seconds, "steps_per_s": steps_s,
                   "gpoints_per_s": steps_s * n / 1e9,
                   "effective_gb_per_s": steps_s * nbytes / 1e9,
                   "max_abs_diff_vs_torch": diff, "field_max": scale,
                   "torch_seconds": ref_s}
            main_rows.append(row)
            say(f"main path {key}: {STEPS} steps in {res.seconds:.3f} s = "
                f"{steps_s:.1f} steps/s, {row['gpoints_per_s']:.2f} Gpoint/s, "
                f"{row['effective_gb_per_s']:.0f} GB/s effective; "
                f"max |diff| vs st.torch() {diff:.3g} (field max {scale:.3g}); "
                f"st.torch() took {ref_s:.1f} s")
            del fields, got
            torch.cuda.empty_cache()
        del ref, ref_fields, init
        torch.cuda.empty_cache()

    # -- 5. absorbing boundary -------------------------------------------------
    clock.next("5 absorbing boundary")
    init = acoustic.make_fields(PML_SHAPE, pml_width=10)
    fresh = lambda: tuple(x.copy() for x in init[:4]) + (init[4],)  # noqa: E731
    refs = {}           # fusion window -> st.torch() fields (the source is
    for fuse in (ACOUSTIC_FUSE, 7):     # injected once a window)
        ref_fields = fresh()
        acoustic_run(st.torch(), ref_fields, fuse)
        refs[fuse] = dict(zip(("p0", "p1"), ref_fields[:2]))
    pml = init[3].data > 0              # damp's halo is 0: the PML's points
    share = min(max(float(r.data[pml].abs().max()) for r in ref.values())
                / max(float(r.data.abs().max()) for r in ref.values())
                for ref in refs.values())
    if share < 1e-2:
        fail(f"acoustic at {PML_SHAPE}: the wave has not reached the PML "
             f"(max there {share} of the field's max)")
    pml_rows = []
    # (label, kernel path, fusion window, expected launch counts): with
    # fuse_steps=7 and k=2 a window is 3 K3 launches and one K2 step
    pml_runs = [(kname, kname, ACOUSTIC_FUSE, {kname: STEPS // KERNELS[kname][1]})
                for kname in KERNELS]
    pml_runs.append(("temporal_step fuse 7", "temporal_step", 7,
                     {"temporal_step": (STEPS // 7) * 3 + (STEPS % 7) // 2,
                      "stream_step": (STEPS // 7) + (STEPS % 7) % 2}))
    for label, kname, fuse, want in pml_runs:
        key = f"acoustic_iso {PML_SHAPE} {label}"
        fields = fresh()
        reset_counts()
        res = acoustic_run(hopper(kname), fields, fuse)
        seen = counts()
        if {g: c for g, c in seen.items() if c} != want:
            fail(f"{key}: launch counts {seen}, expected {want}")
        if res.windows != -(-STEPS // fuse):
            fail(f"{key}: {res.windows} windows")
        diff, scale = max_diff(torch, key, dict(zip(("p0", "p1"), fields[:2])),
                               refs[fuse])
        pml_rows.append({"path": key, "fuse_steps": fuse, "launches": seen,
                         "max_abs_diff_vs_torch": diff, "field_max": scale,
                         "pml_share_of_max": share})
        say(f"absorbing boundary {key}: max |diff| vs st.torch() {diff:.3g} "
            f"(field max {scale:.3g}; in the PML {share:.2f} of it)")
    record["absorbing_boundary"] = pml_rows

    # -- 6. per-application main path --------------------------------------------
    clock.next("6 per-application")
    star_init = suite.make_grids("star3d4r", MAIN_SHAPE, seed=0)

    def star_map(backend):
        # copies on the card of one draw (a 512³ draw takes seconds on the host)
        grids = {g: x.copy() for g, x in star_init.items()}
        k = suite.get_kernel("star3d4r")

        @st.target
        def run(u, v):
            for _ in range(STEPS):
                st.map(e=u.shape)(k)(u, v)
                (u.data, v.data) = (v.data, u.data)
        t0 = time.perf_counter()
        st.launch(backend=backend)(run)(grids["u"], grids["v"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, grids

    def acoustic_map(backend):
        # the wall time of the step loop, source injections included as
        # in the fused run's ``between``; the fields are made before it
        p1, prof = acoustic.run(shape=MAIN_SHAPE, iters=STEPS,
                                pml_width=PML_WIDTH, backend=backend)
        torch.cuda.synchronize()
        return prof["loop"], {"p1": p1}

    map_rows = []
    n = float(np.prod(MAIN_SHAPE))
    for w, run in zip(workloads, (star_map, acoustic_map)):
        ref_s, ref = run(st.torch())
        nbytes = 4 * n * (len(w.kernel.info.input_grids)
                          + len(w.kernel.info.output_grids))
        for ename, (wname, template) in MAP_KERNELS.items():
            key = f"{ename}[{w.name}]"
            reset_counts()
            seconds, got = run(st.hopper(template=template))
            seen = counts()
            if seen[wname] != STEPS or sum(seen.values()) != STEPS:
                fail(f"st.map {key}: launch counts {seen}, expected {STEPS} "
                     f"of {wname} and no other")
            entries[key]["launches"] = seen[wname]
            diff, scale = max_diff(torch, f"st.map {key}", got, ref)
            steps_s = STEPS / seconds
            row = {"path": f"st.map {key}", "template": template,
                   "steps": STEPS, "seconds": seconds, "steps_per_s": steps_s,
                   "gpoints_per_s": steps_s * n / 1e9,
                   "effective_gb_per_s": steps_s * nbytes / 1e9,
                   "max_abs_diff_vs_torch": diff, "field_max": scale,
                   "torch_seconds": ref_s}
            map_rows.append(row)
            say(f"per-application path {key}: {STEPS} st.map in {seconds:.3f}"
                f" s = {steps_s:.1f} steps/s, {row['gpoints_per_s']:.2f} "
                f"Gpoint/s, {row['effective_gb_per_s']:.0f} GB/s effective; "
                f"max |diff| vs st.torch() {diff:.3g} (field max {scale:.3g});"
                f" st.torch() took {ref_s:.1f} s")
            del got
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()
    record["map_path"] = map_rows
    del star_init

    # -- 7. regions and Listing 1 ------------------------------------------------
    clock.next("7 regions and Listing 1")
    k = suite.get_kernel("star3d4r")
    init = suite.make_grids("star3d4r", MAIN_SHAPE, seed=3)
    boxes = regions.seven_region(MAIN_SHAPE, PML_WIDTH)
    region_rows = []

    def whole_map(be):
        whole = {g: x.copy() for g, x in init.items()}
        st.launch(backend=be)(lambda u, v: st.map(e=u.shape)(k)(u, v))(
            whole["u"], whole["v"])
        return whole
    want = whole_map(st.torch())
    for template in ("gmem", "f4"):
        be = st.hopper(template=template)
        whole = whole_map(be)
        diff_torch, _ = max_diff(torch, f"whole-interior {template}", whole,
                                 want)
        parts = {g: x.copy() for g, x in init.items()}

        def seven(u, v):
            for r in boxes:
                st.map(begin=[b for b, _ in r], end=[e for _, e in r])(k)(u, v)
        reset_counts()
        st.launch(backend=be)(seven)(parts["u"], parts["v"])
        seen = counts()
        if seen["map_step"] != len(boxes) or sum(seen.values()) != len(boxes):
            fail(f"seven regions {template}: launch counts {seen}")
        diff, scale = max_diff(torch, f"seven regions {template}", parts, whole)
        region_rows.append({"template": template, "regions": len(boxes),
                            "max_abs_diff_vs_whole": diff,
                            "whole_max_abs_diff_vs_torch": diff_torch})
        say(f"seven regions {template} at {MAIN_SHAPE}: max |diff| vs one "
            f"whole-interior st.map {diff:.3g} (field max {scale:.3g}), "
            f"which is {diff_torch:.3g} from st.torch()")
        del whole, parts
    del init, want
    torch.cuda.empty_cache()

    def listing1(u, v, iters):
        for _ in range(iters):
            st.map(e=u.shape)(listing1_kernel)(u, v)
            (u.data, v.data) = (v.data, u.data)

    def listing1_grids():
        return (st.grid(dtype=st.f32, shape=LISTING1_SHAPE, order=4).randomize(0),
                st.grid(dtype=st.f32, shape=LISTING1_SHAPE, order=4))
    u, v = listing1_grids()
    st.launch(backend=st.torch())(listing1)(u, v, LISTING1_STEPS)
    want = u.interior.clone()
    u, v = listing1_grids()
    reset_counts()
    st.launch(backend=st.cuda(computeCapability="9.0", threadsPerBlock=(8, 128),
                              template="gmem"))(listing1)(u, v, LISTING1_STEPS)
    seen = counts()
    if seen["map_step"] != LISTING1_STEPS or sum(seen.values()) != LISTING1_STEPS:
        fail(f"Listing 1: launch counts {seen}")
    err = float((u.interior - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    # the stencil amplifies oscillatory modes: the quickstart's own limit
    if not err / scale < 1e-5:
        fail(f"Listing 1: max |hopper - torch| = {err} ({err / scale} of "
             f"{scale})")
    say(f"Listing 1 at {LISTING1_SHAPE}, {LISTING1_STEPS} steps: max |hopper "
        f"- torch| {err:.3g} (relative {err / scale:.3g})")
    record["regions"] = region_rows
    record["listing1"] = {"max_abs_diff": err, "relative": err / scale}
    del u, v, want
    torch.cuda.empty_cache()

    # -- 8. serving ------------------------------------------------------------
    clock.next("8 serving")
    lm_mods = {"configs": configs, "api": api, "griffin": griffin,
               "layers": lm_layers, "serve_loop": serve_loop, "conv": conv,
               "conv_ref": conv_ref, "attn": attn}
    serve_row = serve_phase(torch, np, lm_mods, (reset_counts, counts))
    record["serving"] = serve_row

    # -- 9. training -------------------------------------------------------------
    clock.next("9 training")
    train_mods = {"configs": configs, "train_loop": train_loop,
                  "optimizer": optimizer, "data": train_data,
                  "shapes": lm_shapes, "griffin": griffin, "conv_ref": conv_ref}
    train_row = train_phase(torch, train_mods, (reset_counts, counts))
    record["training"] = train_row

    # -- 10. autotune --------------------------------------------------------------
    clock.next("10 autotune")
    at_mods = {"st": st, "suite": suite, "acoustic": acoustic,
               "autotune": autotune, "cost_model": cost_model,
               "timeloop": timeloop}
    record["autotune"], tuned = autotune_phase(torch, at_mods, (reset_counts, counts),
                                               main_rows)

    # -- 11. batched scenarios and the adjoint -------------------------------------
    clock.next("11 batch and adjoint")
    b_mods = {"st": st, "acoustic": acoustic, "suite": suite, "codegen": codegen,
              "wrappers": wrappers, "acoustic_workload": workloads[1],
              "adjoint": adjoint}
    record["batch"] = batch_phase(torch, b_mods, (reset_counts, counts), main_rows,
                                  entries)
    record["adjoint"] = adjoint_phase(torch, b_mods, (reset_counts, counts))

    # -- 12. resilience ------------------------------------------------------------------
    clock.next("12 resilience")
    r_mods = {"st": st, "acoustic": acoustic, "timeloop": timeloop, "adjoint": adjoint,
              "checkpoint": checkpoint, "fault_tolerance": fault_tolerance,
              "configs": configs, "train_loop": train_loop, "optimizer": optimizer,
              "data": train_data, "shapes": lm_shapes, "train_cli": train_cli}
    backend = tuned["acoustic_iso"]
    if backend.kind != "hopper":
        backend = st.hopper(template="gmem")
    record["resilience"] = resilience_phase(torch, r_mods, (reset_counts, counts), backend)
    for name, n in record["resilience"]["forward"]["launches"].items():
        entries[f"{name}[acoustic_iso]"]["resilient_launches"] = n

    # -- 13. stencil serving ---------------------------------------------------------------
    clock.next("13 stencil serving")
    s_mods = {"st": st, "suite": suite, "autotune": autotune, "cost_model": cost_model,
              "stencil_serve": stencil_serve}
    record["stencil_serving"] = stencil_serve_phase(torch, np, s_mods,
                                                    (reset_counts, counts))
    # -- 14. the distributed layer -----------------------------------------------------
    clock.next("14 distributed")
    d_mods = {"st": st, "suite": suite, "acoustic": acoustic, "distributed": distributed,
              "mesh": mesh_mod, "timeloop": timeloop, "adjoint": adjoint,
              "cost_model": cost_model, "autotune": autotune,
              "fault_tolerance": fault_tolerance, "build": _build,
              "map_step": map_step, "map_step_plain": map_step_plain}
    record["distributed"] = distributed_phase(torch, np, d_mods, (reset_counts, counts),
                                              main_rows, map_rows, entries)
    # -- 15. the other language models ----------------------------------------------
    clock.next("15 LM families")
    f_mods = {"configs": configs, "api": api, "encdec": encdec, "layers": lm_layers,
              "serve_loop": serve_loop, "train_loop": train_loop,
              "optimizer": optimizer, "data": train_data, "shapes": lm_shapes}
    record["lm_families"] = lm_families_phase(torch, np, f_mods, (reset_counts, counts))
    # -- 16. the LM side of the distributed layer -------------------------------------
    clock.next("16 sharded training")
    sh_mods = {"configs": configs, "api": api, "griffin": griffin,
               "train_loop": train_loop, "optimizer": optimizer, "data": train_data,
               "shapes": lm_shapes, "mesh": mesh_mod, "sharding": sharding,
               "conv": conv, "conv_ops": conv_ops, "conv_ref": conv_ref,
               "train_cli": train_cli}
    record["sharded_training"], shard_entry = sharded_train_phase(
        torch, sh_mods, (reset_counts, counts), rates)
    record["sharded_families"] = sharded_families_phase(
        torch, sh_mods, (reset_counts, counts), record["lm_families"])
    # -- 17. sharded serving ------------------------------------------------------------
    clock.next("17 sharded serving")
    sv_mods = {**sh_mods, "encdec": encdec, "serve_loop": serve_loop,
               "dryrun": dryrun, "transformer": transformer}
    record["sharded_serving"], serve_entries = sharded_serve_phase(
        torch, np, sv_mods, (reset_counts, counts), rates)
    for e in conv_entries:
        row = serve_row if e["path"] == "serving" else train_row
        e["launches"], e["max_abs_err"] = row["k6_launches"], conv_worst
        e["sharded_launches"] = record["sharded_training"]["train"]["k6_launches"]
        if e["path"] != "serving":
            e["resilient_launches"] = record["resilience"]["training"]["k6_launches"]
    conv_entries += [shard_entry, *serve_entries]
    # -- 18. the dry run's accounting ----------------------------------------------------
    clock.next("18 dry run")
    record["dry_run"] = dry_run_phase(torch, {**sv_mods, "mesh": mesh_mod}, record, smi)
    for kname, e in attn_entries.items():  # standalone: 0 on the serving path
        e["launches"] = serve_row["launches"][kname]
    # -- 19. the examples --------------------------------------------------------------
    clock.next("19 examples")
    record["examples"] = examples_phase(torch, st, (reset_counts, counts), smi)
    clock.stop()
    say(f"seconds a phase ({smi}):")
    clock.table()

    kernels = [entries[f"{k}[{w.name}]"] for w in workloads
               for k in list(KERNELS) + list(MAP_KERNELS)]
    kernels += [*conv_entries, *attn_entries.values()]
    record["kernels"], record["main_path"] = kernels, main_rows
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    # batched_launches: phase 11's launches of a kernel that advanced every
    # scenario of a batched loop; resilient_launches: phase 12's in its
    # restarted runs, replays included; sharded_launches: phase 14's in its
    # sharded st.map and window runs, K6's phase 16's in its sharded training
    # steps (None where a phase does not run it)
    line = {"kernels": [{**{k: e[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "batched_launches": e.get("batched_launches"),
        "resilient_launches": e.get("resilient_launches"),
        "sharded_launches": e.get("sharded_launches")} for e in kernels]}
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
