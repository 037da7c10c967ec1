"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines; any failure exits non-zero before the
final line:

1. env: the card (nvidia-smi name and power limit), torch and CUDA versions
2. build: nvcc build of every kernel (flash attention, the flash probes, the
   3x3 conv, the int8 probe), with ptxas's registers, shared memory and spills
   per kernel; a register spill or a serialized wgmma (C7510-C7515) in the
   forwards', the backward's, the probes', the conv's or the int8 probe's
   source fails the phase, and so does an f32 forward or backward kernel
   without TF32 HGMMA instructions in ``cuobjdump -sass``, a probe or bf16
   conv kernel without bf16 ones, or the int8 kernel without s8 IGMMA ones
3. kernel vs plain, bound and stable forwards: each kernel against its plain
   torch version, both on the card, at the SMALL tier's shapes, for the bound
   forward the LARGE tier's, at lengths around the bf16 kernel's 64-row
   warpgroup and 128-key tile and the f32 kernel's 32-key tile, and in f32 at
   the SLAM cross length (CUDA-event times, median of a few runs, the SM
   clock beside each); the plain version without the f32 kernel's last key
   tile must break each f32 bound; the bf16 cross-view call of either mode
   must run above the f32 pipe's peak rate
4. backward vs plain: the dq and dk/dv kernels against the plain backward at
   the training shapes (f32 and bf16), the SLAM shape and lengths around
   either dtype's tiles; the plain version with its last key or q tile
   dropped must break each bound; the bf16 cross-view calls must run above
   the f32 pipe's peak rate (the f32 kernels' tensor-core instructions are
   read from the built library in phase 2)
5. model f32 parity: the SMALL forward on a 2-frame 518² chunk, CUDA f32
   (kernel) against the same weights on the CPU (plain attention)
6. train grad parity: one SMALL window's loss gradients, card (kernels)
   against CPU (plain), every parameter, in f32 and with bf16 activations
7. train: ``da3slam_tpu_torch.cli.train`` (SMALL, dp, 5 steps of 2 windows
   of 4 views at 504², f32), counting the kernels' launches, then a
   ``torch.profiler`` split of one step; train_bf16: the same run through
   ``make_train_step(dtype=torch.bfloat16)`` (the bf16 forward, dq and dk/dv
   kernels), its losses beside the f32 run's, and its profile
8. flash_attention: the public entry point a user calls (``stable=True``, the
   default) forward and backward, counting the launches, and holding the
   output and the gradients against the plain stable forward and backward
9. main path: ``da3slam_tpu_torch.cli.main_slam`` over 31 generated frames
   (SMALL, chunk 15, overlap 1: two steady chunks and the re-anchored tail),
   counting the launches; then the same solver split into load, loop and
   final fetch (host waits and times apart)
10. conv3x3 vs plain: the 3x3 conv kernels against their plain version and
    beside ``F.conv2d`` (TF32 off in f32) at the DPT head's three shapes in
    bf16 (the wgmma kernel) and the first in f32 (the direct kernel), shapes
    ragged around both kernels' tiles, and a bf16 shape the shape rule sends
    to the direct kernel (its own count shows which ran); a dropped halo row
    or column must break the bound
11. flash probes vs plain: the constant-shift, bisect (A-E) and online-softmax
    lab (old, new, qs) kernels against their plain versions at the tools'
    shapes, a ragged one and lengths around the kernel's 128-row and 128-key
    tiles; there the plain version without the last key tile must break each
    mode's bound
12. int8 flash vs plain: the int8 probe kernel against its plain version at
    the tool's shape, the tool's check shape (a ragged last block) and small
    ragged cases (``block_k`` 64 and 192); the plain version with a key tile
    or its last block dropped must break the bound; the error against f32
    softmax attention beside it; the kernel timed alone on quantized inputs,
    the whole wrapper and its quantization beside it
13. tools: ``da3slam_tpu_torch.tools``' five ``main``s, counting the launches
14. main_align: ``da3slam_tpu_torch.cli.main_align`` at the LARGE tier
    (``--method irls``, ray poses, chunk 15) over the same 31 frames: a finite
    PLY and diagnostics, 72 bound-forward launches
15. w8a8: one LARGE chunk of 15 frames through ``model.quantize()`` against
    the float model (same weights): finite, close, 24 bound-forward launches;
    then a ``torch.profiler`` split of one warm chunk for each
16. main_slam with ``Align.method: irls``: the main path again from a config
    file, device-resident, with the prefetcher's staging on and off, counting
    the launches and the host's waits for the device, whole and split into
    load, loop and final fetch; the ICP loop must not wait at all
17. checkpoint: SMALL written with the port's ``save_checkpoint`` and loaded
    with ``from_pretrained(dir)``: outputs bit-equal to the model that was saved
18. pipeline: ``run_streaming_slam`` over the same 31 frames (SMALL, chunk 15,
    overlap 1), whole and in one-window segments spilled to the host: equal,
    36 bound-forward launches each, and held to phase 16's ``main_slam``
    trajectory (ICP, device-resident); then a ``torch.profiler`` split of one
    warm SMALL chunk
19. loop_closure: ``optimize_sim3_pose_graph`` (dense and CG) and the
    loop-on ``SLAMSolver`` over the 48-frame synthetic loop (revisits as
    first seen, and under a gamma drift), on the card against the same runs
    on the CPU: accepted edges, ATE on below ATE off, poses, host waits
20. main_slam_loop: ``cli/main_slam`` at SMALL with a ``Loop`` block over 72
    frames that revisit themselves (36 and the same 36 reversed): 72 finite
    poses, at least one joint re-inference, 12 bound-forward launches a chunk
    and a joint re-inference, the gate's numbers, host waits
21. streaming: ``cli/streaming`` at SMALL over the same 72 frames (chunks of
    16, overlap 4) with ``Loop``, the TUM/KITTI exports and ``--mesh``: finite
    poses, merged cloud and ``scene_mesh.ply`` (``save_mesh`` timed apart),
    launches as in 20 (the joint re-inference at S = 41632); then
    ``DA3Streaming``'s mesh on the card over the synthetic corner room, on its
    planes, sparse and dense, against the same run on the CPU
22. preprocess: ``cli/preprocess crop --dataset c3vd2`` and ``brightness``
    over 31 generated frames at C3VD's 1080×1350; ``preprocess_batch`` over
    16 of them to 504² timed (frames/s); card against CPU on two frames: the
    uint8 outputs and the CLAHE bin flips
23. tsdf: the 112-frame orbit in the closed box at 504² (``bench.py``'s TSDF
    scene), resolution 192, fused dense, sparse and sparse with carve
    (frames/s, active blocks and budget, host waits, peak memory); card
    against CPU on a strided subset, the sparse grid against dense
    ``band_only`` bit for bit, and the mesh on the box planes (marching
    tetrahedra's host time apart)
24. main_mesh: ``cli/main_mesh`` at SMALL (chunk 8, ``--process_res 504``)
    over phase 22's frames, dense ``--color`` and ``--sparse``: a non-empty
    finite mesh, 12 bound-forward launches a chunk, frames/s
25. rasterize: the tile rasterizer over 2^20 seeded splats at 504² (K = 256,
    fan 5), render and gradients on the card against the CPU, 0 host waits a
    render, render / binning / forward + backward times and peak memory; the
    tiled render against ``rasterize_dense``; the toy training scene's loss
26. main_3dgs: ``cli/main_3dgs`` at SMALL (chunk 8, ``--process_res 504``)
    over phase 22's frames, plain with ``--glb``, then with refinement,
    training and densification: finite PLY and GLB, 12 bound-forward launches
    a chunk, the training loss falling, frames/s, seconds a step, memory
27. render: ``cli/render`` over phase 26's trained PLY along three written
    poses with ``--interp``: PNGs, non-constant frames, card against CPU on
    two frames within 1 LSB
28. nested_checkpoint: the nested tier at full width (giant + large, seeds 0
    and 1) made on the card, its torch-style state dict held to the published
    nested manifest, written as a nested checkpoint directory and loaded back
    bit for bit (bytes, seconds to write and to load)
29. main_slam_nested: ``cli/main_slam`` with ``Weights.DA3`` at that
    directory over the 31 frames (chunk 15: three chunks): 64 bound-forward
    launches a chunk (40 giant blocks, 24 large on the reference view), finite
    poses, each chunk's metric scale, load and run apart, peak memory; then
    export → split → import in memory gives bit-equal outputs on one chunk
30. nested_parity: giant and large widths cut to 4 blocks each (LayerScale
    0.1, depths of order 1), 2 unrelated frames at 518², f32 on the card
    against the CPU within MODEL_PARITY_TOL (depth, conf, poses, intrinsics,
    metric scale); the CPU run writes a golden
31. parity_cli: ``cli/parity`` on the card (bf16) against that golden: PASS
32. main_conf: ``cli/main_conf --stats_only`` at SMALL over 8 frames
33. evaluate: ``cli/evaluate`` on phase 29's trajectory against phase 9's,
    and on a written C3VD-layout sequence (16-bit depth TIFFs, ``pose.txt``)
    whose known answers (the scales) it must recover
34-36. mesh_dp, mesh_sp, mesh_pp: ``run_streaming_slam(mesh=...)`` over the
    31 frames (chunk 16: two windows) at SMALL on two ranks of one gloo group
    time-sharing the card (``parallel/mesh.py:run_ranks``; NCCL refuses two
    ranks on one GPU), dp, sp (8 + 8 views, ring cross-view attention) and pp
    (two stages of 6 blocks), each held to the single-process run of the same
    weights and frames within the bf16 bound (MULTI_TRIANGLE) and dp and pp
    reported bit-equal or not; each rank's bound-forward launches against the
    count from its blocks and hops, its bytes staged through the host, its
    parameter bytes and peak memory, the wall time (time-shared, not scaling);
    sp also holds the card's ring (a bound forward per hop, folded by lse)
    against its plain version at the hop shape, and its whole run in f32 (TF32
    off) against the single-process f32 run within MODEL_PARITY_TOL: what
    tells bf16 reassociation from a ring fault
37. mesh_nccl: dp on one NCCL rank, bit-equal to the single-process run
38. mesh_pp_giant: the giant tier (40 blocks, SwiGLU) in two stages of 20 on
    two gloo ranks, each holding its stage of the blocks only
39-44. train_tp, train_sp, train_pp, train_giant_tp, train_tp4, train_nccl:
    ``cli/train``'s loop (what its spawned ranks run) at SMALL, 504², f32:
    dp x tp on a (1, 2) mesh (3 steps of 2 windows x 4 views), sp on 2 ranks
    (3 steps of one 8-view window: ring hops of (1, 5204, 6, 64)), pp in 2
    stages (3 steps of 3 microbatches of 2 views), giant's widths cut to 4
    blocks on a (1, 2) mesh (one step: the split of SwiGLU's w12), a (2, 2)
    mesh on 4 ranks (one step), all on gloo ranks sharing the card, and one
    NCCL rank on a (1, 1) mesh; per rank the launches of the bound forward,
    dq and dk/dv against the count from blocks, windows and hops, bytes
    through the host, parameter and moment bytes, peak memory, steps/s
    (time-shared: function, not scaling); replicated parameters bit-equal
    across the ranks; one step's every gradient, put back together, against
    the single-process step on the card (TRAIN_MESH_ARGS); sp also holds the
    ring's backward (the dq and dk/dv kernels a hop) against its plain
    version at the hop shape in f32 and bf16, and NCCL the one-device step
    bit for bit (as far as that step repeats itself)
45. main_slam_viewer: ``SLAMSolver(viewer="auto")`` (device-resident) and
    ``cli/main_slam`` without ``--headless``, each through a recording stub
    ``viser`` module this script defines (the card has none): 31 frames
    reach the viewer, each cloud and frustum equal to a host recomputation
    from the fetched depth, intrinsics and global extrinsics, the frusta at
    the trajectory's centres, 36 bound-forward launches a run, at most one
    host wait a chunk in the viewer's update; frames/s with the viewer beside
    the same solver headless, in turns; the CLI's stay-alive loop ended
    through its ``time.sleep``
46. main_align_viewer: ``cli/main_align --method irls`` at SMALL without
    ``--headless`` through the stub: the first and last frame of each chunk
    reach the viewer, each cloud equal to its host recomputation
47. main_video: ``cli/main_video --crop 0.9 --brightness`` with
    ``video_to_frames`` replaced by a writer of the 31 frames, ``--mode
    streaming --traj_formats tum`` and ``--mode slam --headless``: the output
    files, finite poses, 12 launches a chunk
48. batch_viewer: ``show_prediction(mask_sky=True)`` over a SMALL prediction
    through the stub: one batch, clouds against the host, the sky mask's
    confidences
49. profile_trace: a SMALL chunk under ``utils/profiling.py:profile_trace``;
    the Chrome trace names the bf16 bound forward kernel 12 times, and holds
    the port's ``model.inference`` and ``model.dpt`` spans with kernels
    launched inside them
50. main_conf_figures: ``cli/main_conf`` without ``--stats_only``: the PNGs
    where matplotlib imports, else an error naming matplotlib before the
    model runs, and nothing written (the case that ran is printed)
51. native: the port's C++ point-cloud library built (timed) and loaded;
    ``write_ply`` / ``read_ply`` native against numpy at 11,430,720 points
    (bytes and arrays equal, seconds), ``voxel_downsample`` and the 3DGS
    writer against their numpy paths
52. icp_graph: ICP at the cells' shapes (504², stride 4, 12 iterations) as a
    captured CUDA graph against its eager body, bit for bit, with and without
    scale; the capture's wall time, a replay's host µs and device ms beside
    the eager body's, and no host wait in a replay

The forward phase (3) also holds the bound forward at that joint length, at
main_mesh's chunk-8 cross length (S = 10408, also sp's ring hop), at the
nested tier's giant and metric shapes and at the multi-device paths' (chunk
16 at SMALL and giant width, sp's 8 views).
Each driven path (7 twice, 8, 9, 13, 14, 15, 16, 18, 20, 21, 22, 23, 24 twice,
25, 26 twice, 27, 29, 32, 34-44 on each rank and 34-38 in their
single-process runs, 45 twice, 46, 47 twice, 48, 49 and 50) sets every launch
count to 0 just before it and reads them just after.  The ``kernels`` line gives each kernel's
launches, error, time, plain version's time, roofline bound (from the shapes
of this run, against the H100 SXM data sheet's peaks) and, where one PyTorch
call computes the same function, that call's time (timed here, used nowhere
in the port).  The last line is ``{"ok": true, "device": {...}}``.
There is no CPU fallback: without CUDA the script exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"

# (name, dtype, shape [B, S, H, D]).  Intra and cross are the SMALL tier at
# process_res 504, chunk 15: 15 views of 36*36 + 1 + 4 = 1301 tokens, folded
# into one sequence of 19515 for the cross-view blocks.  train_intra and
# train_cross are what the training path gives the forwards: f32, 4 views at
# 504² (4 x 1301 tokens, folded into 5204).
KERNEL_CASES = [
    ("intra", torch.bfloat16, (15, 1301, 6, 64)),
    ("cross", torch.bfloat16, (1, 19515, 6, 64)),
    ("ragged", torch.bfloat16, (2, 300, 3, 64)),
    ("f32", torch.float32, (2, 1301, 6, 64)),
    ("train_intra", torch.float32, (4, 1301, 6, 64)),
    ("train_cross", torch.float32, (1, 5204, 6, 64)),
]
# what the LARGE main_align path gives the bound forward: 16 heads
LARGE_CASES = [
    ("large_intra", torch.bfloat16, (15, 1301, 16, 64)),
    ("large_cross", torch.bfloat16, (1, 19515, 16, 64)),
]
# what the nested tier's main_slam gives the bound forward: giant (24 heads)
# within each of 15 views and across the chunk, and the large metric model on
# the reference view alone (16 heads over one view's 1301 tokens)
GIANT_CASES = [
    ("giant_intra", torch.bfloat16, (15, 1301, 24, 64)),
    ("giant_cross", torch.bfloat16, (1, 19515, 24, 64)),
    ("metric_single", torch.bfloat16, (1, 1301, 16, 64)),
]
# lengths around the bf16 kernel's tiles (64 query rows a warpgroup, 128 a CTA,
# 128 keys a stage): one row, one short of, exactly and one past each edge;
# and around the f32 kernel's (32 keys a stage, 64 rows a warpgroup, 128 a CTA)
EDGE_CASES = [(f"edge{S}", torch.bfloat16, (2, S, 3, 64)) for S in (1, 63, 64, 65, 127, 128, 129)]
F32_EDGE_CASES = [(f"edge{S}_f32", torch.float32, (2, S, 3, 64))
                  for S in (1, 31, 32, 33, 63, 64, 65, 127, 128, 129)]
# the f32 forwards at the SLAM cross length: the tensor cores' truncating sums
# over 19515 keys (the error must not grow with S)
F32_LONG_CASES = [("slam_cross_f32", torch.float32, (1, 19515, 6, 64))]
# the stable forward adds the input where the bound forward underflows: q
# scaled 30x (diffuse logits of norm ~350); there the bound kernel gives zeros
STABLE_CASES = [(n, d, s, 1.0) for n, d, s in KERNEL_CASES + EDGE_CASES + F32_EDGE_CASES
                + F32_LONG_CASES] + [
    ("30x", torch.float32, (1, 1301, 6, 64), 30.0),
]
# the backward at the training shapes (4 views at 504²: intra 4 x 1301,
# cross 5204) and a ragged case in f32 (the CLI's training dtype) and in bf16
# (make_train_step(dtype=torch.bfloat16)), the SLAM cross shape in bf16, and
# lengths around the kernels' tiles: bf16 (64 own rows a warpgroup, 128 a
# CTA, ring stages of 64 keys for dq and 32 q rows for dk/dv) and f32 (64 own
# rows a CTA, 32 rows a stage for both, S padded to 64).  At S = 1 dq is 0 up
# to the order of f32 sums (dz = dO.v - dO.O with O = v), which no relative
# bound can hold: tests/test_torch_flash_attention.py has that case with an
# absolute floor.
BWD_CASES = [
    ("train_intra", torch.float32, (4, 1301, 6, 64)),
    ("train_cross", torch.float32, (1, 5204, 6, 64)),
    ("ragged", torch.float32, (2, 300, 3, 64)),
    ("slam_cross", torch.bfloat16, (1, 19515, 6, 64)),
    ("train_intra_bf16", torch.bfloat16, (4, 1301, 6, 64)),
    ("train_cross_bf16", torch.bfloat16, (1, 5204, 6, 64)),
    ("ragged_bf16", torch.bfloat16, (2, 300, 3, 64)),
] + [(f"edge{S}_bf16", torch.bfloat16, (2, S, 3, 64)) for S in (63, 64, 65, 127, 128, 129)] + [
    (f"edge{S}", torch.float32, (2, S, 3, 64)) for S in (31, 32, 33, 63, 64, 65, 129)]
# the bf16 backward cases that must run above the f32 pipe's peak rate
BWD_TENSOR_CORE_CASES = ("slam_cross", "train_cross_bf16")
# Bounds on max |kernel - plain|, forwards.  Both round p to V's dtype at the
# same place, so in bf16 they differ by the output's final rounding: at most
# one bf16 ulp of the largest |O|.  The bound is 2^-6 * max |O|, which is 2-4
# such ulps; it scales with |O|, which is ~0.04 at the cross shape, where a
# fixed 2e-2 would pass a dropped key tile.  f32 keeps the JAX package's own
# bound for this forward (tests/test_flash_attention.py: 5e-5).  lse sums
# every key's p, so a dropped or repeated key tile moves it by more than
# LSE_TOL: dropping the ragged last tile (59 keys) at the cross shape moves
# both lse and O by about 1e-2.  The stable bf16 kernel and its plain version
# both round p against the running max after each 128-key tile, so they too
# differ only in the order of f32 sums (the tensor cores' is not fmaf's).  In
# f32 p is not rounded, and the kernel's 32-key step only reorders sums; its
# products are 3xTF32 (~21 bits of each, against f32's 24), its tensor-core
# sums truncate, and P.V is promoted into f32 sums every 8 tiles.  A kernel
# that dropped the ragged last 32-key tile breaks F32_TOL and LSE_TOL: the
# forward phase checks that at every f32 shape.
BF16_REL_TOL = 2.0 ** -6
F32_TOL = 5e-5
LSE_TOL = 1e-3
# At the 30x input the logits s and lse are 100-200 in magnitude (f32 ulp
# 1.5e-5), from 64-term dot products summed in another order: lse differs by
# ~10 ulps, and each p = exp2(s - m) by ~1e-5 relative, so O (|O| up to ~4,
# the best key's v) is held to 1e-4 of max |O| instead of F32_TOL.
LSE_TOL_30X = 2e-4
F32_REL_TOL_30X = 1e-4
# Bounds on max |kernel - plain| of each gradient, relative to its max |g|.
# f32: the kernels take every product as 3xTF32 (hi·hi + hi·lo + lo·hi of
# TF32 halves, ~2^-21 relative a product against f32's 2^-24) and sum in
# another order; their tensor-core sums truncate each addition, so they add 8
# tiles at a time and promote each block into an f32 sum rounded to nearest.
# Measured 1e-6 to 4e-6 of max|g| up to S = 5204 (6e-5 there before the
# promotion: the truncation's bias grows with S); 1e-4 is 25x that.  One TF32
# product in place of three is 7e-4 to 1.7e-3 (tools/flash_bwd_stages.py,
# tests/test_torch_flash_attention.py::TestTf32BackwardModel).  bf16: dz and p
# are rounded to bf16 at the same points, but an f32 difference can tip a value
# at a rounding boundary, and the outputs are rounded to bf16 (one ulp = 2^-8
# relative): 2^-6, as for O.  A
# kernel that skipped the ragged last key tile (dq) or q tile (dk/dv) moves
# the gradient by several percent of max|g|: the backward phase checks that
# each bound catches it at each shape.
BWD_F32_REL_TOL = 1e-4
# The 3x3 conv: (label, dtype, N, H, W, C, COUT, relu).  The three DPT-head
# shapes of the probe tool in bf16 (the wgmma kernel) and the first of them in
# f32 (the direct kernel); shapes ragged in H and W around both kernels' pixel
# tiles (16 x 32 for strips of 32 channels, 16 x 16 for strips of 128), in
# COUT (strips) and, in f32, in C (the direct kernel's chunks of 8); and one
# bf16 shape with C % 8 != 0, which the shape rule sends to the direct kernel.
# Kernel and plain version take the same exact products of T-rounded values
# and differ in the order of up to 9*C f32 sums; bf16 outputs are then rounded
# (one ulp = 2^-8 relative), so bf16 is held to 2^-6 * max |out| as the
# attention output is, and f32 to the JAX package's own 1e-4.  A kernel that
# dropped a tile's halo row or column would lose three taps x C terms there
# (~1 in magnitude): the phase checks that each bound catches it.
CONV_CASES = [
    ("head2-small", torch.bfloat16, 16, 504, 504, 64, 32, False),
    ("head2-large", torch.bfloat16, 16, 504, 504, 128, 32, True),
    ("head1-large", torch.bfloat16, 16, 288, 288, 256, 128, False),
    ("head2-small_f32", torch.float32, 16, 504, 504, 64, 32, False),
    ("ragged_f32", torch.float32, 3, 45, 77, 21, 40, True),
    ("ragged_bf16", torch.bfloat16, 3, 45, 77, 24, 40, True),
    ("ragged_bf16_n128", torch.bfloat16, 2, 37, 41, 8, 130, False),
    ("direct_bf16", torch.bfloat16, 2, 37, 45, 21, 40, True),
]
CONV_F32_TOL = 1e-4
# The flash probes at the tools' shapes: S = 16 * 1301 = 20816 padded to the
# TPU tool's blocks (21504 queries and keys), the lab at S = 20480 (its padded
# length), BH = 6, bf16; a ragged small case (Sq, Sk, seq_k); and lengths
# around the kernel's tiles (128 query rows a CTA, 128 keys a stage), Sq and
# Sk apart, seq_k in the first tile and in the last.  At those lengths, where
# the last key tile holds at least PROBE_DROP_MIN keys below seq_k, the plain
# version without that tile must break the bound of O or lse
# (dropped_probe_tile_errors): every mode is checked so at one shape or more.
PROBE_S, PROBE_PAD, LAB_S = 20816, 21504, 20480
PROBE_RAGGED = (300, 333, 290)
PROBE_EDGES = [(127, 127, 127), (128, 128, 100), (129, 129, 129), (255, 255, 255),
               (257, 257, 257), (257, 257, 100), (129, 257, 200), (257, 129, 129),
               (200, 255, 250)]
PROBE_DROP_MIN = 64
# lse of the bisect probes at the tile-edge lengths: LSE_TOL plus one rounding
# tip of the row's largest p.  p is rounded to bf16 at the same point in the
# kernel and the plain version, but a p within the last f32 bits of a rounding
# boundary rounds either way (the two differ there in exp2 and in the order
# of the score's sums) and moves l by up to 2^-7 of that p: lse by up to
# 2^-7/ln 2 of p_max/l.  At 127-129 keys the tools' inputs put up to 30% of a
# row's mass on one key: the plain version in f32 is then 1.4e-3 from the same
# formula in f64.  At the tools' shapes and the ragged one the share is small
# and the bound is LSE_TOL alone.
LSE_TIP = 2.0 ** -7 / 0.6931471805599453
# The int8 flash probe: (label, dtype, shape [B, S, H, D], block_k): the tool's
# shape, the tool's check shape (1500 keys in blocks of 512: a ragged last
# block of 476), a small ragged case and blocks of one and of three of the
# kernel's 64-key tiles (a tile never straddles two blocks).  Kernel and plain
# version quantize with the same tensor code, take the same exact integer
# products and convert them to f32 at the same points, so they differ where
# the card's exp2 (ex2) differs from torch.exp2 (if at all: a p8 at a rounding
# boundary tips by one count of the 10^3-10^4 in a row's sum, ~1e-4 relative)
# and by the bf16 output's last bit: 2^-6 * max |O|, as for the other
# forwards.  A kernel that skipped one 64-key tile, or the ragged last block,
# would move O by several times that: the phase checks that the bound catches
# both at each shape.
INT8_CASES = [
    ("tool", torch.bfloat16, (1, 20816, 6, 64), 3584),
    ("check", torch.float32, (1, 1500, 2, 64), 512),
    ("ragged", torch.bfloat16, (2, 300, 3, 64), 128),
    ("bk64", torch.bfloat16, (1, 1000, 2, 64), 64),
    ("bk192", torch.float32, (2, 700, 3, 64), 192),
]
INT8_SOFTMAX_REL_TOL = 0.08  # the tool's limit, at its check shape
# W8A8 against float at LARGE: tests/test_quant.py's limits (depth relative
# L2, extrinsics max abs)
W8A8_DEPTH_REL_TOL = 0.05
W8A8_EXT_TOL = 0.05
# run_streaming_slam against itself in segments and against main_slam: the
# same operations queued on the same inputs (tests/test_torch_pipeline.py: 1e-4)
PIPELINE_TOL = 1e-4
# The H100 SXM data sheet's dense peaks, for the roofline bounds
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_TF32_FLOPS = 495e12
# exp2 on the special-function units: 16 a clock an SM, at the clock the bf16
# peak implies (4096 FLOP a clock an SM): one exp2 per 256 peak bf16 FLOP.  An
# attention forward needs B·H·S² of them, beside its 4·B·H·S²·D operations
PEAK_EXP2_PER_S = PEAK_FLOPS[torch.bfloat16] / 256
PEAK_BYTES_PER_S = 3.35e12
# f32 card-vs-CPU parity: max |cuda - cpu| / max |cpu| per output / parameter
MODEL_PARITY_TOL = 1e-3
DPT_BIAS = 5.0  # keeps the DPT head's ReLU inputs off 0 (phase_train_grad_parity)
# bf16 card-vs-CPU gradient parity (kernels against plain versions, the same
# weights and window).  Both sides round activations to bf16 at the same
# places, so they differ where a sum taken in another order tips a rounding
# (2^-8 relative each time), compounded over 12 blocks and the DPT head, and a
# parameter whose gradient is a small difference of large terms (the head's
# last biases) shows it whole.  Held: the relative L2 error of the whole
# gradient, and of each parameter's gradient.  For scale: the bf16 step's
# gradient is 3e-2 (whole) and up to 0.7 (one bias) from the f32 step's in the
# JAX package itself (tests/test_torch_train.py measures it).
# Measured: 4.2e-3 and 6.8e-2 (the final norm's weight); the bounds are ~3x that.
GRAD_PARITY_BF16_TOL = 1.5e-2
GRAD_PARITY_BF16_PARAM_TOL = 0.2
# the bf16 step's losses against the f32 step's on the same batches: bf16
# activations move a loss by ~5e-3 relative at the tiny preset
# (tests/test_torch_train.py); at SMALL, whose LayerScale starts at 1e-5,
# 1.6e-3 at the first step and under 1e-4 after it
TRAIN_BF16_LOSS_REL_TOL = 1e-2
N_FRAMES = 31
# Host waits the device-resident solver's loop may make over the 31 frames
# (torch.cuda.set_sync_debug_mode): none with ICP; with IRLS, torch.linalg.svd
# and det wait for the device, 21 times over the two aligned chunks
ICP_LOOP_SYNCS = 0
IRLS_LOOP_SYNCS = 21
EXPECTED_LAUNCHES = 12 * 3  # 12 encoder blocks x 3 chunks
ALIGN_ARGS = ["--model", "large", "--method", "irls", "--chunk_size", "15", "--overlap", "1",
              "--headless"]
ALIGN_EXPECTED_LAUNCHES = 24 * 3  # LARGE: 24 encoder blocks x 3 chunks
# The loop paths read 36 generated frames and the same 36 in reverse: 72
# frames whose second half revisits the first.  main_slam takes them in
# chunks of 15 (overlap 1), the streaming CLI in its default chunks of 16
# (overlap 4): six chunks each, 12 bound-forward launches a chunk (SMALL),
# and 12 more for each joint re-inference over two chunks (30 and 32 frames:
# S = 39030 and 41632).  Retrieval is loose enough that a revisit is always
# found (the identical frames' learned descriptors); with random weights the
# gate may reject the constraint, so acceptance is not required there.
LOOP_FRAMES = 72
LOOP_CHUNKS = 6
LOOP_BLOCK = ("Loop: {enable: true, "
              "Retrieval: {threshold: 0.5, min_gap: 30, max_loops: 1}}\n")
# the bound forward at the streaming path's joint length (32 views of 1301)
JOINT_CASES = [("joint_cross", torch.bfloat16, (1, 32 * 1301, 6, 64))]
# main_mesh's chunk of 8 views: its cross-view blocks at S = 8 x 1301
MESH_CHUNK = 8
MESH_CASES = [("mesh_cross", torch.bfloat16, (1, MESH_CHUNK * 1301, 6, 64))]
# 31 frames in chunks of 8, overlap 1: (0,8) (7,15) (14,22) (21,29) and the
# re-anchored tail (23,31), 12 bound-forward launches each (SMALL)
MESH_CHUNKS = 5
# C3VD's frame size (H, W); the dense-mapping paths read 31 such frames
C3VD_HW = (1080, 1350)
# bench.py's TSDF scene: 112 orbit frames at 504² inside the closed box, a
# 192-voxel grid, sparse batches of 16
TSDF_FRAMES, TSDF_HW, TSDF_RES, TSDF_BATCH = 112, 504, 192, 16
# card against CPU (the same eager ops in both): sdf and weight within 1e-5,
# colour 1e-3, apart from voxels whose nearest pixel rounds otherwise, at
# most this share of the grid (tests/test_torch_tsdf.py's bound)
TSDF_TOL, TSDF_EDGE_SHARE = 1e-5, 0.01
# CLAHE bin flips card against CPU: at most this share of the pixels or 2
# (tests/test_torch_preprocess.py's bound); frames with none within 1 LSB
PREPROCESS_FLIP_SHARE = 1e-5
# card against CPU, the pose graph: the same LM sequence, LU / CG sums in
# another order (tests/test_torch_loop.py holds the port to the JAX package
# at 1e-5 dense, 1e-4 CG over 6-8 nodes; here dense over 16, CG over 6).
# Both are held at convergence: a CG solve cut short (5 LM iterations of at
# most 32 CG steps) left the card 1.7e-3 from the CPU, rounding that the
# unconverged iterations amplify, not an error of the solution
POSEGRAPH_TOL = {"dense": 1e-4, "cg": 1e-3}
# card against CPU, the loop-on solver over the synthetic loop: the CPU
# test's bound, 1e-4 of the scene extent
LOOP_SOLVER_REL_TOL = 1e-4
# the rasterizer at the CLIs' settings: 2^20 seeded splats at 504², K = 256
# and fan 5; card against CPU within RASTER_RGB_TOL (rgb and alpha) and
# RASTER_GRAD_REL_TOL of each attribute's largest CPU gradient
RASTER_SPLATS, RASTER_HW = 1 << 20, 504
RASTER_RGB_TOL, RASTER_GRAD_REL_TOL = 1e-4, 1e-3
# main_3dgs's optimisation passes: steps chosen to keep the phase near 60 s
GS_REFINE_ITERS, GS_TRAIN_ITERS, GS_DENSIFY_EVERY = 10, 3, 2
# render: three written poses with two slerped cameras on each edge; card
# against CPU on two frames, within 1 LSB on this share of the pixels
# (tests/test_torch_main_3dgs.py's bound against the JAX package)
RENDER_INTERP, RENDER_LSB_SHARE = 2, 0.999
# The nested tier at full width: giant (any-view, seed 0) and large (metric,
# seed 1) made on the card, written as a torch-style nested checkpoint
# directory and run by main_slam over the 31 frames (chunk 15, overlap 1: three
# chunks).  Each chunk runs the bound forward once a giant block and once a
# large block on the reference view
NESTED_NAME = "DA3NESTED-GIANT-LARGE-1.1"
NESTED_EXPECTED_LAUNCHES = (40 + 24) * 3
# card against CPU in f32 (MODEL_PARITY_TOL) and the parity CLI: giant and
# large widths cut to 4 blocks each, 2 frames at 518²
NESTED_PARITY_DEPTH = 4
# Random weights put the depth channel's pre-activation at -25..49 at giant
# width (the head's He init over 384-1536 channels), so 1% of the depths sit
# in softplus's exponential tail (1e-11 m), where a bf16 error of the
# pre-activation is the same relative error of the depth: the parity CLI's
# bf16 run measured depth AbsRel 0.0224 against the f32 golden on an H100
# (the plain bf16 path on the CPU, no kernel: 0.054).  A trained head outputs depths of
# order 1 m: the reduced nested model's last conv scales that channel by 0.05
# and biases it to 2 (depths 1.1-4.5; the CPU's bf16 AbsRel 0.004), as
# phase_train_grad_parity moves the DPT biases off the ReLUs' kink
NESTED_DEPTH_WEIGHT_SCALE, NESTED_DEPTH_BIAS = 0.05, 2.0
# Likewise the poses: at the initial LayerScale (1e-5) the camera token is the
# cls token to 1e-5, so two views' poses differ by 1e-9 while bf16 rounds the
# raw translations at ~1e-5, and the parity CLI's trans_rel on two drifted
# frames was noise over noise (0.0009 and 0.65 in two H100 runs).  The reduced
# model takes LayerScale 0.1 (a trained DINOv2's order) and two unrelated
# frames (make_frames seeds 0 and 5): a relative translation of 4.6e-4, and
# trans_rel 0.0388 against the bound's 0.05 in the card's bf16 (the same in
# two H100 runs; 0.014 in the CPU's bf16)
NESTED_PARITY_LAYERSCALE, NESTED_PARITY_FRAME_SEEDS = 0.1, (0, 5)
# main_conf's chunk (its default) at SMALL: 12 bound-forward launches
CONF_CHUNK = 8
# Multi-device SLAM inference (phases 34-38): ranks of one process group
# sharing the one card.  NCCL refuses two ranks on one GPU, so the two-rank
# phases run gloo with CUDA tensors (``parallel/comm.py`` stages the
# point-to-point hops through pinned host memory; gloo's collectives copy
# through host memory themselves); the NCCL phase runs one rank.  The main
# path's 31 frames at chunk 16, overlap 1: two windows; sp splits each
# window's 16 views 8 + 8.  Random weights from seed 0 made on the card, the
# same on every rank and in the single-process run they are held to (the same
# frames with mesh=None), with LayerScale 0.1: at the presets' 1e-5 every
# residual branch, attention included, vanishes under the bf16 rounding of
# the residual stream, and a ring that attended wrongly would still agree.
# Closed-form Umeyama alignment, as tests/test_torch_pipeline.py: ICP on a
# random model's depth amplifies rounding.
MULTI_CHUNK, MULTI_RANKS, MULTI_WINDOWS = 16, 2, 2
MULTI_LAYERSCALE = 0.1
MULTI_TIMEOUT_S = 300
# The bf16 bound on max |mesh - single| of each output: twice what bf16 moves
# that output in the single-process run (max |single bf16 - single f32|, the
# same run in f32).  A mesh path that computes the same function with its
# bf16 roundings elsewhere is, like the single run, about that far from the
# f32 result, so at most twice it from the single run.  dp and pp run the
# one-device path's operations at its shapes (expected bit-equal); sp runs
# the MLPs and the head on 8 views, not 16, and the cross-view attention as
# two blocks folded by lse against one flash call over 20816 keys (bf16 O
# and p rounded against another bound)
MULTI_TRIANGLE = 2.0
# the bound forward at the multi-device paths' shapes: chunk 16 (dp, pp) at
# SMALL and giant width, and sp's 8 local views within a view (its ring hops
# are MESH_CASES' 8 x 1301 keys)
MULTI_CASES = [
    ("chunk16_intra", torch.bfloat16, (16, 1301, 6, 64)),
    ("chunk16_cross", torch.bfloat16, (1, 16 * 1301, 6, 64)),
    ("sp_intra", torch.bfloat16, (8, 1301, 6, 64)),
    ("giant16_intra", torch.bfloat16, (16, 1301, 24, 64)),
    ("giant16_cross", torch.bfloat16, (1, 16 * 1301, 24, 64)),
]
TRAIN_STEPS, TRAIN_BATCH, TRAIN_VIEWS, TRAIN_HW = 5, 2, 4, 504
TRAIN_ARGS = ["--preset", "small", "--mode", "dp", "--steps", str(TRAIN_STEPS),
              "--batch", str(TRAIN_BATCH), "--views", str(TRAIN_VIEWS),
              "--hw", str(TRAIN_HW), str(TRAIN_HW), "--log_every", "1"]


# Multi-device training (phases 39-44): the train steps on ranks of one
# process group sharing the card (gloo; NCCL refuses two ranks on one GPU),
# and one NCCL rank.  SMALL at 504², f32 as cli/train runs, random weights
# from the seed.  Each mode runs cli/train's loop (``_train``, what the CLI's
# spawned ranks run) with the CLI's arguments, counted; then one step of the
# same step function from conditioned weights (TRAIN_GRAD_SEED; LayerScale
# 0.5, the camera output layer x300, the DPT biases DPT_BIAS, random target
# poses: phase_train_grad_parity's conditioning, so that every gradient is a
# quantity) under highest_precision, whose every gradient, put back together
# over the ranks, is held to the single-process step of the same weights and
# batch on the card: every parameter's within MODEL_PARITY_TOL in relative
# L2, and the encoder blocks' (the tensors tp splits, the sp ring's and the pp
# stages' gradients) within it of their largest value too.  Elsewhere the
# largest error is a noise measure: a DPT-head ReLU input within rounding of
# 0 moves one position's whole term (card against CPU, SMALL: the head's
# projects.0 at 5.9e-4 of its max, 1e-5 in L2, on an H100), and pos_embed's
# gradient sums the views' terms of either sign at each position (sp against
# one process: 9.0e-4 of its max).  At giant width the head's ReLU inputs
# spread over tens, DPT_BIAS no longer keeps them off 0, and its gradients
# move with every flipped unit (projects.0: 2.1e-3 in L2, tp against one
# process): train_giant_tp holds the encoder's and reports the head's apart.
TRAIN_MESH_TIMEOUT_S = 600
TRAIN_MESH_ARGS = {
    # dp x tp: 2 windows x 4 views, the blocks' linears split over 2 tp ranks
    "tp": ["--mode", "dp", "--devices", "2", "--tp", "2", "--steps", "3", "--batch", "2",
           "--views", "4"],
    # sp: one window of 8 views, 4 a rank: each rank's ring hop is (1, 5204, 6, 64)
    "sp": ["--mode", "sp", "--devices", "2", "--steps", "3", "--batch", "1", "--views", "8"],
    # pp: 2 stages of 6 blocks, M = 3 microbatches of 2 views
    "pp": ["--mode", "pp", "--stages", "2", "--steps", "3", "--batch", "3", "--views", "2"],
    # a (2, 2) mesh: one window a dp rank
    "tp4": ["--mode", "dp", "--devices", "4", "--tp", "2", "--steps", "1", "--batch", "2",
            "--views", "4"],
    # one NCCL rank, mesh (1, 1)
    "nccl": ["--mode", "dp", "--devices", "1", "--steps", "3", "--batch", "2", "--views", "4"],
    # giant's widths (D 1536, 24 heads, SwiGLU 4096) cut to TRAIN_GIANT_DEPTH
    # blocks, all tapped by the DPT head, as the nested parity cell cuts them
    # (NESTED_PARITY_DEPTH): tp 2 splits w12's gate and value
    "giant_tp": ["--mode", "dp", "--devices", "2", "--tp", "2", "--steps", "1", "--batch", "1",
                 "--views", "4"],
}
TRAIN_MESH_COMMON = ["--preset", "small", "--hw", "504", "504", "--log_every", "1"]
TRAIN_GRAD_SEED, TRAIN_GRAD_LAYERSCALE = 3, 0.5
TRAIN_GIANT_DEPTH = 4
# the ring's backward at sp's hop, card against its plain version
TRAIN_RING_SHAPE = (1, 4 * 1301, 6, 64)


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; ``t_s`` is the time since the script started."""
    print(json.dumps({"phase": phase, "t_s": round(time.perf_counter() - T_START, 2), **fields}),
          flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def fwd_bound(o_ref: torch.Tensor, q_scale: float = 1.0) -> float:
    """Bound on max |O_kernel - O_plain| (see BF16_REL_TOL, F32_TOL and
    F32_REL_TOL_30X)."""
    if o_ref.dtype == torch.bfloat16:
        return BF16_REL_TOL * o_ref.float().abs().max().item()
    if q_scale != 1.0:
        return F32_REL_TOL_30X * o_ref.abs().max().item()
    return F32_TOL


def grad_bound(g_ref: torch.Tensor) -> float:
    """Bound on max |g_kernel - g_plain| (see BWD_F32_REL_TOL / BF16_REL_TOL)."""
    rel = BF16_REL_TOL if g_ref.dtype == torch.bfloat16 else BWD_F32_REL_TOL
    return rel * g_ref.float().abs().max().item()


def conv_bound(out_ref: torch.Tensor) -> float:
    """Bound on max |out_kernel - out_plain| of the 3x3 conv (see CONV_CASES)."""
    if out_ref.dtype == torch.bfloat16:
        return BF16_REL_TOL * out_ref.float().abs().max().item()
    return CONV_F32_TOL


def dropped_halo_errors(kernel, bias, x, out_ref, relu: bool) -> dict:
    """Max |Δ| at the first interior tile edge when the plain conv loses the
    halo there: what a kernel that staged its tile without the neighbouring
    column (or row) would show.  ``out_ref`` is the whole plain output."""
    from da3slam_tpu_torch.ops.conv3x3 import TILE_H, TILE_W, conv3x3_reference

    cut_w = conv3x3_reference(kernel, bias, x[:1, :, TILE_W:TILE_W + 4], relu=relu)
    cut_h = conv3x3_reference(kernel, bias, x[:1, TILE_H:TILE_H + 4], relu=relu)
    return {
        "column": (cut_w[:, :, 0].float() - out_ref[:1, :, TILE_W].float()).abs().max().item(),
        "row": (cut_h[:, 0].float() - out_ref[:1, TILE_H].float()).abs().max().item(),
    }


def roofline(flop: float, nbytes: float, dtype: torch.dtype) -> dict:
    """The least time the card could take: the larger of operations over the
    peak rate of their type and bytes (each input read once, each output
    written once) over the memory rate.  f32 work is held to the 67 TFLOP/s
    f32 rate; the TF32 tensor-core figure stands beside it."""
    t_ops = flop / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    out = {"bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "flop": flop, "bytes": nbytes}
    if dtype == torch.float32:
        out["bound_ms_tf32"] = max(flop / PEAK_TF32_FLOPS, t_bytes) * 1e3
    return out


def attention_roofline(shape, dtype, flop_per_score: int, n_tensors: int, n_rows: int) -> dict:
    """Roofline of an attention kernel on ``[B, S, H, D]``: ``flop_per_score``
    · B·H·S²·D operations (4 forward, 6 dq, 8 dk/dv), ``n_tensors`` tensors of
    the shape and ``n_rows`` f32 ``[B·H, S]`` rows in and out."""
    B, S, H, D = shape
    elem = torch.empty((), dtype=dtype).element_size()
    return roofline(flop_per_score * B * H * S * S * D,
                    n_tensors * B * S * H * D * elem + n_rows * B * H * S * 4, dtype)


def tf32_roofline(shape, dtype, flop_per_score: int, n_tensors: int, n_rows: int) -> dict:
    """Roofline of an attention kernel (4 forward, 6 dq, 8 dk/dv).  The f32
    kernels take each product three times on the TF32 tensor cores (3xTF32),
    so their bound is three times the operations at the TF32 peak; the f32
    FMA pipe's bound stands beside it (``bound_ms_f32_fma``)."""
    r = attention_roofline(shape, dtype, flop_per_score, n_tensors=n_tensors, n_rows=n_rows)
    if dtype != torch.float32:
        return r
    r.pop("bound_ms_tf32")
    t_ops = 3 * r["flop"] / PEAK_TF32_FLOPS
    t_bytes = r["bytes"] / PEAK_BYTES_PER_S
    return {**r, "bound_ms_f32_fma": r["bound_ms"], "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def sdpa_ms(q, k, v, reps: int = 5, scale=None) -> float:
    """Time of one ``F.scaled_dot_product_attention`` call on ``[B, S, H, D]``
    inputs (viewed as ``[B, H, S, D]``): the library's forward."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, scale=scale), reps)


def sdpa_backward_ms(q, k, v, g, reps: int = 5) -> float:
    """Time of the autograd backward of one ``scaled_dot_product_attention``
    call (dq, dk and dv together): the library's backward."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)
    gt = g.transpose(1, 2)
    return cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt, retain_graph=True), reps)


def dropped_tile_errors(q, k, v, do, lse, delta, grads) -> list[float]:
    """Max |Δ| of (dq, dk, dv) when the plain backward drops the last (ragged)
    key tile from dq and the last q tile from dk/dv: what a kernel with that
    fault would show.  ``grads`` are the whole plain gradients.  The tiles are
    the kernels' ring stages: in bf16 64 keys for dq and 32 q rows for dk/dv,
    in f32 32 rows for both."""
    from da3slam_tpu_torch.ops.flash_attention import (
        BWD_F32_TILE,
        BWD_TILE,
        BWD_TILE_DKV,
        flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq_reference,
    )

    B, S, H, _ = q.shape
    bf16 = q.dtype == torch.bfloat16
    tile = BWD_TILE if bf16 else BWD_F32_TILE
    cut = (S - 1) // tile * tile
    dq_cut = flash_attention_bwd_dq_reference(q, k[:, :cut], v[:, :cut], do, lse, delta)
    tile = BWD_TILE_DKV if bf16 else BWD_F32_TILE
    cut = (S - 1) // tile * tile

    def rows(x):
        return x.reshape(B, H, S)[:, :, :cut].reshape(B * H, cut)

    dk_cut, dv_cut = flash_attention_bwd_dkv_reference(q[:, :cut], k, v, do[:, :cut],
                                                       rows(lse), rows(delta))
    return [(a.float() - b.float()).abs().max().item()
            for a, b in zip(grads, (dq_cut, dk_cut, dv_cut))]


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, after one warm-up."""
    from da3slam_tpu_torch.utils.profiling import time_ms

    return time_ms(fn, "cuda", reps)


def counters():
    from da3slam_tpu_torch.ops import conv3x3, flash_probes, int8_flash
    from da3slam_tpu_torch.ops import flash_attention as fa

    return {"flash_attn_bound_fwd": fa.flash_attention_bound,
            "flash_attn_stable_fwd": fa.flash_attention_stable,
            "flash_attn_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attn_bwd_dkv": fa.flash_attention_bwd_dkv,
            "conv3x3": conv3x3.conv3x3_fused,
            "flash_probe_nomax": flash_probes.flash_nomax,
            "flash_probe_bisect": flash_probes.flash_bisect,
            "flash_probe_lab": flash_probes.flash_lab,
            "int8_flash_fwd": int8_flash.int8_flash}


def expected_launches(**nonzero: int) -> dict:
    """Every kernel's expected count on a path: 0 unless named."""
    return {name: nonzero.get(name, 0) for name in counters()}


@contextlib.contextmanager
def counted(path_launches: dict, path: str):
    """Set every launch count to 0 just before a driven path, read them just
    after into ``path_launches[path]``."""
    for fn in counters().values():
        fn.launches = 0
    counters()["conv3x3"].direct_launches = 0
    yield
    path_launches[path] = {name: fn.launches for name, fn in counters().items()}


def gpu_state() -> str:
    """The card's clocks, temperature and power draw now (nvidia-smi), to
    stand beside a time taken just before."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu,"
         "power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def phase_env() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("env", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def tensor_core_instructions(library: Path) -> dict:
    """``cuobjdump -sass`` of a built library: each kernel's HGMMA and IGMMA
    (float and integer ``wgmma``) instructions by kind and count, under its
    mangled name."""
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        fail("cuobjdump not found (PATH or /usr/local/cuda/bin): cannot read the kernels' SASS")
    sass = subprocess.run([exe, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout
    kernels: dict = {}
    name = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"[HI]GMMA\.\S+", ln)
        if m and name:
            kinds = kernels.setdefault(name, {})
            kinds[m.group(0)] = kinds.get(m.group(0), 0) + 1
    return kernels


# the sources of the tensor-core kernels: no spill, no serialized wgmma
WGMMA_SOURCES = ("flash_attn_fwd.cu", "flash_attn_bwd.cu", "flash_probe_fwd.cu", "conv3x3.cu",
                 "int8_flash_fwd.cu")


def phase_build() -> None:
    from da3slam_tpu_torch.ops import flash_attention as fa

    fa.build_kernel()
    ptxas = {src: [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                   if "Compiling entry" in ln or "registers" in ln or "spill" in ln]
             for src, log in fa._Kernel.build_logs.items()}
    hgmma = {src: tensor_core_instructions(fa._Kernel.paths[src]) for src in WGMMA_SOURCES}
    emit("build", seconds=fa._Kernel.build_seconds,
         libraries=[str(p.relative_to(ROOT)) for p in fa._Kernel.paths.values()], ptxas=ptxas,
         hgmma=hgmma)
    # the f32 kernels run on the tensor cores: TF32 wgmma in the SASS of each
    # (both instantiations of the forward: bound and stable); the probe
    # template's eight instantiations and the bf16 conv's two (strips of 32
    # and 128 channels) bf16 wgmma; the int8 probe s8 wgmma (IGMMA)
    for src, kernel, n, kind in (("flash_attn_fwd.cu", "flash_fwd_tf32_kernel", 2, r"\.TF32"),
                                 ("flash_attn_bwd.cu", "flash_bwd_dq_tf32_kernel", 1, r"\.TF32"),
                                 ("flash_attn_bwd.cu", "flash_bwd_dkv_tf32_kernel", 1, r"\.TF32"),
                                 ("flash_probe_fwd.cu", "flash_probe_kernel", 8, r"\.BF16"),
                                 ("conv3x3.cu", "conv3x3_wgmma_kernel", 2, r"\.BF16"),
                                 ("int8_flash_fwd.cu", "int8_flash_kernel", 1, r"^IGMMA\..*\.S8")):
        found = [kinds for name, kinds in hgmma[src].items() if kernel in name]
        if len(found) != n or not all(any(re.search(kind, k) for k in kinds) for kinds in found):
            fail(f"{kernel}: not {n} instantiations with {kind} tensor-core instructions in its "
                 f"SASS ({found})")
    # the tensor-core kernels' accumulators must stay in registers and their
    # wgmmas asynchronous (a log exists when this process built the library,
    # as it does in a fresh checkout)
    for src in WGMMA_SOURCES:
        log = fa._Kernel.build_logs.get(src, "")
        spills = [ln.strip() for ln in log.splitlines()
                  if any(int(n) for n in re.findall(r"(\d+) bytes spill", ln))]
        serialized = [ln.strip() for ln in log.splitlines() if re.search(r"C751[0-5]", ln)]
        if spills or serialized or "wgmma.mma_async instructions are serialized" in log:
            fail(f"{src}: register spills {spills} or serialized wgmma {serialized} "
                 "(ptxas C7510-C7515)")


def dropped_key_tile_errors(q, k, v, o, lse) -> dict | None:
    """Max |Δ| of O and lse against the plain forward over all keys but the
    f32 kernel's last (ragged) 32-key tile: what a kernel that skipped or
    mis-masked that tile would show.  O and lse are the same quantities in
    either mode, so the plain stable forward serves both.  None where the last
    tile is the only one."""
    from da3slam_tpu_torch.ops.flash_attention import (
        FWD_F32_TILE,
        flash_attention_stable_reference,
    )

    cut = (q.shape[1] - 1) // FWD_F32_TILE * FWD_F32_TILE
    if cut == 0:
        return None
    o_cut, lse_cut = flash_attention_stable_reference(q, k[:, :cut], v[:, :cut])
    return {"o": (o.float() - o_cut.float()).abs().max().item(),
            "lse": (lse - lse_cut).abs().max().item()}


def _forward_case(fwd, ref, name, dtype, shape, scale, gen) -> dict:
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype) for _ in range(3))
    q = (q.float() * scale).to(dtype)
    o, lse = fwd(q, k, v)
    o_ref, lse_ref = ref(q, k, v)
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    tol = fwd_bound(o_ref, scale)
    lse_err = (lse - lse_ref).abs().max().item()
    lse_tol = LSE_TOL_30X if scale != 1.0 else LSE_TOL
    finite = bool(torch.isfinite(o).all().item())
    ms = cuda_ms(lambda: fwd(q, k, v), reps=5)
    state = gpu_state()
    plain_ms = cuda_ms(lambda: ref(q, k, v), reps=3)
    B, S, H, D = shape
    row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
           "q_scale": scale, "max_abs_err": err, "tol": tol,
           "plain_max_abs": o_ref.float().abs().max().item(), "lse_max_abs_err": lse_err,
           "lse_tol": lse_tol, "ms": ms, "gpu_state": state, "plain_ms": plain_ms,
           "library_ms": sdpa_ms(q, k, v), "library": "F.scaled_dot_product_attention",
           "kernel_tflops": 4 * B * H * S * S * D / ms / 1e9,
           "exp2_floor_ms": B * H * S * S / PEAK_EXP2_PER_S * 1e3,
           **tf32_roofline(shape, dtype, 4, n_tensors=4, n_rows=1)}
    if scale != 1.0:
        from da3slam_tpu_torch.ops.flash_attention import flash_attention_bound

        row["bound_kernel_all_zero"] = bool((flash_attention_bound(q, k, v)[0] == 0).all().item())
        if not row["bound_kernel_all_zero"]:
            fail(f"the bound kernel did not underflow to zeros at {name}")
    if not finite or not err <= tol:
        fail(f"{fwd.__name__} disagrees with its plain version at {name}: {err} > {tol}")
    if not lse_err <= lse_tol:
        fail(f"{fwd.__name__} lse disagrees with its plain version at {name}: "
             f"{lse_err} > {lse_tol}")
    if dtype == torch.float32:
        row["dropped_tile_err"] = cut = dropped_key_tile_errors(q, k, v, o, lse)
        if cut is not None and not (cut["o"] > tol and cut["lse"] > lse_tol):
            fail(f"the {fwd.__name__} bounds at {name} ({tol}, {lse_tol}) would pass a dropped "
                 f"last key tile ({cut})")
    # above the f32 pipe's peak only the tensor cores can be at work
    f32_peak_tflops = PEAK_FLOPS[torch.float32] / 1e12
    if name == "cross" and dtype == torch.bfloat16 and not row["kernel_tflops"] > f32_peak_tflops:
        fail(f"{fwd.__name__} runs the bf16 cross call at {row['kernel_tflops']} TFLOP/s, "
             f"not above the f32 pipe's {f32_peak_tflops}: not on the tensor cores")
    return row


def phase_forwards() -> dict:
    from da3slam_tpu_torch.ops import flash_attention as fa

    rows = {}
    for kernel, fwd, ref, cases in (
        ("flash_attn_bound_fwd", fa.flash_attention_bound, fa.flash_attention_bound_reference,
         [(n, d, s, 1.0) for n, d, s in KERNEL_CASES + LARGE_CASES + JOINT_CASES
          + MESH_CASES + GIANT_CASES + MULTI_CASES + EDGE_CASES + F32_EDGE_CASES
          + F32_LONG_CASES]),
        ("flash_attn_stable_fwd", fa.flash_attention_stable, fa.flash_attention_stable_reference,
         STABLE_CASES),
    ):
        gen = torch.Generator(device="cuda").manual_seed(0)
        rows[kernel] = []
        for name, dtype, shape, scale in cases:
            row = _forward_case(fwd, ref, name, dtype, shape, scale, gen)
            emit("kernel_vs_plain", kernel=kernel, **row)
            rows[kernel].append(row)
            torch.cuda.empty_cache()
    return rows


def phase_backward() -> dict:
    from da3slam_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"flash_attn_bwd_dq": [], "flash_attn_bwd_dkv": []}
    for name, dtype, shape in BWD_CASES:
        q, k, v, g = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                      for _ in range(4))
        o, lse = fa.flash_attention_bound(q, k, v)
        delta = fa.attention_delta(o, g)
        dq = fa.flash_attention_bwd_dq(q, k, v, g, lse, delta)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta)
        refs = (fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta))
        torch.cuda.synchronize()
        errs, tols = {}, {}
        for gname, a, r in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
            if not bool(torch.isfinite(a).all().item()):
                fail(f"{gname} kernel output not finite at {name}")
            errs[gname] = (a.float() - r.float()).abs().max().item()
            tols[gname] = grad_bound(r)
        cut_errs = dict(zip(("dq", "dk", "dv"), dropped_tile_errors(q, k, v, g, lse, delta, refs)))
        dq_ms = cuda_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, g, lse, delta), reps=5)
        dkv_ms = cuda_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, g, lse, delta), reps=5)
        dq_plain = cuda_ms(lambda: fa.flash_attention_bwd_dq_reference(q, k, v, g, lse, delta), 3)
        dkv_plain = cuda_ms(lambda: fa.flash_attention_bwd_dkv_reference(q, k, v, g, lse, delta), 3)
        B, S, H, D = shape
        flop = B * H * S * S * D
        library_ms = sdpa_backward_ms(q, k, v, g)
        row = {"case": name, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
               "gpu_state": gpu_state(), "library_ms": library_ms,
               "library": "autograd backward of F.scaled_dot_product_attention "
                          "(dq, dk and dv together)",
               "max_abs_err": errs, "tol": tols, "dropped_tile_err": cut_errs,
               "dq_ms": dq_ms, "dkv_ms": dkv_ms, "dq_plain_ms": dq_plain,
               "dkv_plain_ms": dkv_plain,
               "bwd_tflops": 14 * flop / (dq_ms + dkv_ms) / 1e9,
               "dq_tflops": 6 * flop / dq_ms / 1e9, "dkv_tflops": 8 * flop / dkv_ms / 1e9}
        emit("backward_vs_plain", **row)
        for gname in errs:
            if not errs[gname] <= tols[gname]:
                fail(f"{gname} kernel disagrees with the plain backward at {name}: "
                     f"{errs[gname]} > {tols[gname]}")
            if not cut_errs[gname] > tols[gname]:
                fail(f"the {gname} bound at {name} ({tols[gname]}) would pass a dropped "
                     f"tile ({cut_errs[gname]})")
        # above the f32 pipe's peak only the tensor cores can be at work
        f32_peak_tflops = PEAK_FLOPS[torch.float32] / 1e12
        if name in BWD_TENSOR_CORE_CASES and not min(row["dq_tflops"],
                                                      row["dkv_tflops"]) > f32_peak_tflops:
            fail(f"the bf16 backward runs {name} at {row['dq_tflops']} (dq) and "
                 f"{row['dkv_tflops']} (dk/dv) TFLOP/s, not above the f32 pipe's "
                 f"{f32_peak_tflops}: not on the tensor cores")
        # dq reads q, k, v, dO, lse, Δ and writes dq; dk/dv writes two tensors
        rows["flash_attn_bwd_dq"].append({
            **row, "max_abs_err": errs["dq"], "ms": dq_ms, "plain_ms": dq_plain,
            **tf32_roofline(shape, dtype, 6, n_tensors=5, n_rows=2)})
        rows["flash_attn_bwd_dkv"].append({
            **row, "max_abs_err": max(errs["dk"], errs["dv"]), "ms": dkv_ms,
            "plain_ms": dkv_plain, **tf32_roofline(shape, dtype, 8, n_tensors=6, n_rows=2)})
        del q, k, v, g, o, lse, delta, dq, dk, dv, refs
        torch.cuda.empty_cache()
    return rows


def make_frames(n: int, hw: int = 518, seed: int = 0) -> np.ndarray:
    """Smooth textured uint8 frames drifting sideways, made with numpy."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32) / hw
    phases = rng.uniform(0, 2 * np.pi, size=(3, 3))
    frames = []
    for i in range(n):
        x = xx + 0.01 * i
        img = np.stack([
            0.5 + 0.25 * np.sin(2 * np.pi * (3 * x + 2 * yy) + phases[c, 0])
            + 0.2 * np.sin(2 * np.pi * (7 * yy - 5 * x) + phases[c, 1])
            for c in range(3)
        ], -1)
        img = img + rng.normal(scale=0.02, size=img.shape)
        frames.append(np.clip(img * 255, 0, 255).astype(np.uint8))
    return np.stack(frames)


def phase_model_parity() -> None:
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.models.da3 import DepthAnything3

    frames = make_frames(2)
    cpu = DepthAnything3.from_pretrained("small", seed=0, device="cpu")
    gpu = DepthAnything3(cpu.cfg, copy.deepcopy(cpu.net).to("cuda"), dtype=torch.float32)
    p_cpu = cpu.inference(image=frames)
    with highest_precision():  # no TF32 in cuBLAS or cuDNN
        p_gpu = gpu.inference(image=frames)
        torch.cuda.synchronize()
    errs = {}
    for field in ("depth", "conf", "extrinsics", "intrinsics"):
        a, b = getattr(p_gpu, field), getattr(p_cpu, field)
        if a.shape != b.shape or not np.isfinite(a).all():
            fail(f"model parity: {field} shape {a.shape} vs {b.shape} or non-finite")
        errs[field] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
    emit("model_f32_parity", preset="small", frames=2, input_hw=518,
         processed_hw=list(p_gpu.depth.shape[1:]), max_rel_err=errs, tol=MODEL_PARITY_TOL)
    if not all(e <= MODEL_PARITY_TOL for e in errs.values()):
        fail(f"model f32 parity beyond {MODEL_PARITY_TOL}: {errs}")


def phase_train_grad_parity(dtype: torch.dtype = torch.float32) -> None:
    """One SMALL window (2 views at 280²): every parameter's gradient on the
    card (kernels, TF32 off) against the CPU's (plain versions), in f32 (max
    relative error per parameter, MODEL_PARITY_TOL) or with bf16 activations
    (relative L2 errors, GRAD_PARITY_BF16_TOL and GRAD_PARITY_BF16_PARAM_TOL).

    The weights are conditioned so that every gradient is a quantity and not
    f32 noise: the poses are relative to view 0, so with the init's
    LayerScale 1e-5 (the views' camera tokens nearly equal) and its 1e-3
    camera output layer (every rotation near the identity) the camera head's
    gradients cancel to noise.  LayerScale 0.5, the output layer x300 and
    random target poses fix that (tests/test_torch_train.py does the same
    against JAX).  The DPT head's convolutions get bias DPT_BIAS: with the
    init's zero biases, a few of its ~10^7 ReLU inputs lie within f32
    rounding of 0, the two devices round them to opposite sides, and each
    such unit moves one position's whole term of a weight gradient (f32
    against f64 on the CPU: 4e-3 of max |g| at bias 0, 8e-5 at bias 5)."""
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.models.da3 import init_params
    from da3slam_tpu_torch.parallel.train import UNUSED_PARAMS, synthetic_batch, window_loss

    cfg = get_preset("small")
    batch = synthetic_batch(cfg, 1, 2, (280, 280), seed=0)
    batch["extrinsics"] = batch["extrinsics"] + np.random.default_rng(9).normal(
        scale=0.3, size=batch["extrinsics"].shape).astype(np.float32)
    cpu = init_params(cfg, seed=0)
    with torch.no_grad():
        for blk in cpu.blocks:
            blk.ls1.gamma.fill_(0.5)
            blk.ls2.gamma.fill_(0.5)
        cpu.camera_head.out.weight.mul_(300.0)
        for m in cpu.depth_head.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.bias.fill_(DPT_BIAS)
    gpu = copy.deepcopy(cpu).to("cuda")
    losses, grads = {}, {}
    for dev, net in (("cpu", cpu), ("cuda", gpu)):
        b = {k: torch.from_numpy(x[0]).to(dev) for k, x in batch.items()}
        with highest_precision():  # the forward AND the backward: no TF32
            loss = window_loss(net, cfg, b["images"], b["depth"], b["extrinsics"], dtype)
            loss.backward()
        losses[dev] = loss.item()
        grads[dev] = {n: p.grad for n, p in net.named_parameters()}
    no_grad = {dev: sorted(n for n, g in gs.items() if g is None) for dev, gs in grads.items()}
    expected_none = sorted(n for n in grads["cpu"] if n.startswith(UNUSED_PARAMS))
    worst, worst_name, n_zero = 0.0, None, 0
    worst_l2, worst_l2_name, sq_diff, sq_ref = 0.0, None, 0.0, 0.0
    for name, g_cpu in grads["cpu"].items():
        g_gpu = grads["cuda"][name]
        if g_cpu is None:
            continue
        if g_gpu is None or not bool(torch.isfinite(g_gpu).all().item()):
            fail(f"train grad parity: {name} has no finite gradient on the card")
        g_gpu = g_gpu.cpu()
        ref = g_cpu.abs().max().item()
        diff = (g_gpu - g_cpu).abs().max().item()
        if ref == 0.0:
            n_zero += 1
            if diff != 0.0:
                fail(f"train grad parity: {name} is exactly zero on the CPU, not on the card")
            continue
        if diff / ref > worst:
            worst, worst_name = diff / ref, name
        d2, r2 = (g_gpu - g_cpu).double().square().sum().item(), g_cpu.double().square().sum().item()
        sq_diff, sq_ref = sq_diff + d2, sq_ref + r2
        if (d2 / r2) ** 0.5 > worst_l2:
            worst_l2, worst_l2_name = (d2 / r2) ** 0.5, name
    bf16 = dtype == torch.bfloat16
    emit("train_grad_parity_bf16" if bf16 else "train_grad_parity", preset="small", views=2,
         hw=[280, 280], dtype=str(dtype).replace("torch.", ""),
         loss=losses, params=len(grads["cpu"]), params_without_grad=no_grad["cuda"],
         params_zero_grad=n_zero, max_rel_err=worst, worst_param=worst_name,
         rel_l2_err=(sq_diff / sq_ref) ** 0.5, worst_param_rel_l2_err=worst_l2,
         worst_rel_l2_param=worst_l2_name,
         tol={"rel_l2": GRAD_PARITY_BF16_TOL, "param_rel_l2": GRAD_PARITY_BF16_PARAM_TOL}
         if bf16 else MODEL_PARITY_TOL)
    if no_grad["cuda"] != expected_none or no_grad["cpu"] != expected_none:
        fail(f"train grad parity: parameters without a gradient {no_grad}, expected only "
             f"{expected_none} (never read by the forward)")
    if bf16:
        if not ((sq_diff / sq_ref) ** 0.5 <= GRAD_PARITY_BF16_TOL
                and worst_l2 <= GRAD_PARITY_BF16_PARAM_TOL):
            fail(f"bf16 train grad parity: relative L2 error {(sq_diff / sq_ref) ** 0.5} of the "
                 f"whole gradient, {worst_l2} of {worst_l2_name}")
    elif not worst <= MODEL_PARITY_TOL:
        fail(f"train grad parity: {worst_name} off by {worst} relative")


def _kernel_category(name: str) -> str:
    if any(s in name for s in ("flash_fwd", "key_norm_max", "flash_probe", "int8_flash")):
        return "attention_fwd"
    # the backward kernels and their pre-passes (q' folded, (lse, Δ) pairs
    # padded)
    if any(s in name for s in ("flash_bwd", "fold_q", "pad_rows")):
        return "attention_bwd"
    # the f32 operands split into TF32 halves: one kernel serves the forwards'
    # pre-pass and the backward's, so its name cannot tell them apart
    if "split_tf32" in name:
        return "attention_f32_split (fwd and bwd)"
    low = name.lower()
    if any(s in low for s in ("conv", "cudnn", "fprop", "dgrad", "wgrad")):
        return "conv (DPT head, patch embed)"
    if any(s in low for s in ("gemm", "cutlass", "matmul", "nvjet")):  # nvjet: cuBLAS on sm_90
        return "gemm"
    if "upsample" in low:
        return "upsample (DPT head)"
    if "layer_norm" in low:
        return "layernorm"
    if "multi_tensor_apply" in low:  # AdamW's foreach kernels
        return "optimizer"
    return "other"


def _profile(phase: str, fn, **fields) -> None:
    """``torch.profiler`` over one warm call of ``fn`` (synchronised): wall,
    device busy time and the busy time split by kind of kernel (an idle share
    is slambench's ``device.idle_share``: Σ self device time counts
    overlapping streams twice).
    The profiler's own tracing of every host call stretches the wall time, and
    a host-bound call's time spreads from one call to the next, so five more
    warm calls are timed without it (``wall_ms_unprofiled``: their median)."""
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm-up
    torch.cuda.synchronize()
    unprofiled_runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        unprofiled_runs.append((time.perf_counter() - t0) * 1e3)
    unprofiled_ms = float(np.median(unprofiled_runs))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_cat: dict[str, float] = {}
    top = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA \
                or getattr(e, "is_user_annotation", False):
            continue  # an annotation spans kernels that are counted on their own
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us <= 0:
            continue
        cat = _kernel_category(e.key)
        by_cat[cat] = by_cat.get(cat, 0.0) + us / 1e3
        top.append((us / 1e3, e.count, e.key[:90]))
    busy = sum(by_cat.values())
    emit(phase, **fields, wall_ms=wall_ms, wall_ms_unprofiled=unprofiled_ms,
         wall_ms_unprofiled_runs=unprofiled_runs, device_busy_ms=busy,
         split_ms=by_cat, split_share={k: v / busy for k, v in by_cat.items()} if busy else {},
         top_kernels=sorted(top, reverse=True)[:15])


def _profile_step(cfg, dtype: torch.dtype = torch.float32, phase: str = "train_profile") -> None:
    from da3slam_tpu_torch.parallel.train import make_train_step, synthetic_batch

    init_fn, step_fn, place = make_train_step(cfg, "cuda", dtype=dtype)
    state = init_fn(seed=1)
    batch = place(synthetic_batch(cfg, TRAIN_BATCH, TRAIN_VIEWS, (TRAIN_HW, TRAIN_HW), seed=7))
    _profile(phase, lambda: step_fn(state, batch), dtype=str(dtype).replace("torch.", ""))


def train_expected_launches(cfg) -> dict:
    """steps x windows x blocks of the bound forward, dq and dk/dv (windows run
    one after another; remat off)."""
    per_attention = TRAIN_STEPS * TRAIN_BATCH * cfg.depth
    return expected_launches(flash_attn_bound_fwd=per_attention, flash_attn_bwd_dq=per_attention,
                             flash_attn_bwd_dkv=per_attention)


def phase_train(path_launches: dict) -> list[float]:
    from da3slam_tpu_torch.cli import train
    from da3slam_tpu_torch.models.config import get_preset

    cfg = get_preset("small")
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "train"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            train.main(TRAIN_ARGS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    lines = [json.loads(ln) for ln in out.getvalue().splitlines() if ln.startswith("{")]
    losses = [ln["loss"] for ln in lines if "loss" in ln and "step" in ln]
    launches = path_launches["train"]
    expected = train_expected_launches(cfg)
    emit("train", args=TRAIN_ARGS, wall_s=wall, steps_per_s=TRAIN_STEPS / wall,
         windows_per_s=TRAIN_STEPS * TRAIN_BATCH / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         launches=launches, expected_launches=expected,
         launch_formula=f"steps {TRAIN_STEPS} x windows {TRAIN_BATCH} x blocks {cfg.depth} "
                        "(windows run one after another; remat off)")
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    if launches != expected:
        fail(f"train: launches {launches} != {expected}")
    _profile_step(cfg)
    return losses


def phase_train_bf16(path_launches: dict, f32_losses: list[float]) -> None:
    """The bf16 step, reached as in the JAX package: no CLI flag, but
    ``make_train_step(dtype=torch.bfloat16)`` (f32 master weights and AdamW
    state, bf16 activations).  The CLI's run again in bf16: SMALL, the same
    seed, batches and learning rate, 5 steps of 2 windows of 4 views at 504²,
    through the bf16 forward and the bf16 dq and dk/dv kernels; its losses
    beside the f32 run's; then a ``torch.profiler`` split of one warm step."""
    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.parallel.train import make_train_step, synthetic_batch

    cfg = get_preset("small")
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "train_bf16"):
        t0 = time.perf_counter()
        init_fn, step_fn, place = make_train_step(cfg, "cuda", dtype=torch.bfloat16)
        state = init_fn(seed=0)
        losses = []
        for step in range(TRAIN_STEPS):
            batch = place(synthetic_batch(cfg, TRAIN_BATCH, TRAIN_VIEWS, (TRAIN_HW, TRAIN_HW),
                                          seed=step))
            state, loss = step_fn(state, batch)
            losses.append(float(loss))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches["train_bf16"]
    expected = train_expected_launches(cfg)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, f32_losses)]
    emit("train_bf16", preset="small", steps=TRAIN_STEPS, batch=TRAIN_BATCH, views=TRAIN_VIEWS,
         hw=TRAIN_HW, dtype="bfloat16", wall_s=wall, steps_per_s=TRAIN_STEPS / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         f32_losses=f32_losses, loss_rel_diff=rel, loss_rel_tol=TRAIN_BF16_LOSS_REL_TOL,
         param_dtypes=sorted({str(p.dtype) for p in state.net.parameters()}),
         launches=launches, expected_launches=expected)
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"train_bf16: losses {losses}")
    if launches != expected:
        fail(f"train_bf16: launches {launches} != {expected}")
    if not max(rel) <= TRAIN_BF16_LOSS_REL_TOL:
        fail(f"train_bf16: losses {losses} differ from the f32 run's {f32_losses} by {rel}")
    _profile_step(cfg, torch.bfloat16, "train_bf16_profile")


def phase_public_flash_attention(path_launches: dict) -> None:
    """A user's call of the public entry point (stable=True, the default),
    forward and backward, at the training cross-view shape; the output and
    q/k/v's gradients against the plain stable forward and plain backward on
    the same inputs (bounds: fwd_bound, grad_bound)."""
    from da3slam_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_backward_reference,
        flash_attention_stable_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    shape = (1, 5204, 6, 64)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").requires_grad_()
               for _ in range(3))
    g = torch.randn(shape, generator=gen, device="cuda")
    with counted(path_launches, "flash_attention"):
        out = flash_attention(q, k, v)
        out.backward(g)
        torch.cuda.synchronize()
    launches = path_launches["flash_attention"]
    expected = expected_launches(flash_attn_stable_fwd=1, flash_attn_bwd_dq=1,
                                 flash_attn_bwd_dkv=1)
    finite = all(bool(torch.isfinite(t).all().item()) for t in (out, q.grad, k.grad, v.grad))
    with torch.no_grad():
        o_ref, lse_ref = flash_attention_stable_reference(q, k, v)
        refs = dict(zip(("dq", "dk", "dv"), flash_attention_backward_reference(
            q.detach(), k.detach(), v.detach(), o_ref, lse_ref, g)))
    errs = {"out": (out.detach() - o_ref).abs().max().item()}
    tols = {"out": fwd_bound(o_ref)}
    for name, t in zip(("dq", "dk", "dv"), (q, k, v)):
        errs[name] = (t.grad - refs[name]).abs().max().item()
        tols[name] = grad_bound(refs[name])
    emit("flash_attention", shape=list(shape), dtype="float32", stable=True,
         finite=finite, launches=launches, expected_launches=expected,
         max_abs_err=errs, tol=tols)
    if not finite or launches != expected:
        fail(f"flash_attention: finite={finite}, launches {launches} != {expected}")
    for name in errs:
        if not errs[name] <= tols[name]:
            fail(f"flash_attention: {name} disagrees with the plain version: "
                 f"{errs[name]} > {tols[name]}")


def frames_dir() -> Path:
    """The 31 generated 518² PNG frames the SLAM and alignment paths read."""
    from PIL import Image

    image_dir = WORK / "frames"
    if not image_dir.exists():
        image_dir.mkdir(parents=True)
        for i, f in enumerate(make_frames(N_FRAMES, seed=1)):
            Image.fromarray(f).save(image_dir / f"{i:06d}.png")
    return image_dir


def phase_main_path(path_launches: dict) -> None:
    from da3slam_tpu_torch.cli import main_slam

    image_dir = frames_dir()
    out_dir = WORK / "out"
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "main_slam"):
        t0 = time.perf_counter()
        main_slam.main(["--image_dir", str(image_dir), "--output_dir", str(out_dir), "--headless"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches["main_slam"]
    expected = expected_launches(flash_attn_bound_fwd=EXPECTED_LAUNCHES)
    poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
    ok = poses.shape == (N_FRAMES, 16) and np.isfinite(poses).all()
    # the same solver split into load, loop and final fetch (launch counts
    # already read).  The CLI's default config keeps the reference's host
    # path: every chunk is fetched, so its loop waits by design
    split = solver_split(main_slam.DEFAULT_CONFIG)
    split.pop("poses")
    emit("main_path", frames=N_FRAMES, wall_s=wall, frames_per_s=N_FRAMES / wall,
         wall_includes="building SMALL on the CPU, its upload, PNG decode, export",
         split=split,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         poses_shape=list(poses.shape), poses_finite=bool(np.isfinite(poses).all()),
         kernel_launches=launches, expected_launches=expected)
    if not ok:
        fail(f"camera_poses.txt: shape {poses.shape}, finite={np.isfinite(poses).all()}")
    if launches != expected:
        fail(f"kernel launches on the main path: {launches} != {expected}")


def probe_roofline(Sq: int, Sk: int, n_rows: int) -> dict:
    """4·BH·Sq·Sk·D operations; q, O, k, v in bf16 and ``n_rows`` f32 [BH, Sq] rows."""
    return roofline(4 * 6 * Sq * Sk * 64, 6 * 64 * 2 * (2 * Sq + 2 * Sk) + n_rows * 6 * Sq * 4,
                    torch.bfloat16)


def phase_conv3x3() -> dict:
    from da3slam_tpu_torch.ops.conv3x3 import conv3x3_fused, conv3x3_reference, uses_wgmma
    from da3slam_tpu_torch.tools.probe_conv3x3 import conv_inputs, library_conv

    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for label, dtype, N, H, W, C, COUT, relu in CONV_CASES:
        # the tool's inputs from another seed, and a bias that is not zero
        x, k = conv_inputs(N, H, W, C, COUT, "cuda", dtype, seed=3)
        b = torch.randn(COUT, generator=gen, device="cuda")
        direct_before = conv3x3_fused.direct_launches
        out = conv3x3_fused(k, b, x, relu=relu)
        ran_direct = conv3x3_fused.direct_launches > direct_before
        ref = conv3x3_reference(k, b, x, relu=relu)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = conv_bound(ref)
        halo = dropped_halo_errors(k, b, x, ref, relu)
        lib = library_conv(k, b, x)
        # F.conv2d rounds its bf16 bias add: a yardstick of speed, not held to
        # the bound; in f32 with TF32 off (torch's default runs cuDNN in TF32),
        # so that it computes the f32 function
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            lib_out = lib().permute(0, 2, 3, 1)
            library_ms = cuda_ms(lib, reps=5)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        if relu:
            lib_out = lib_out.relu()
        lib_diff = (lib_out.float() - ref.float()).abs().max().item()
        elem = x.element_size()
        row = {"case": label, "dtype": str(dtype).replace("torch.", ""),
               "shape": [N, H, W, C, COUT], "relu": relu,
               "kernel": "direct" if ran_direct else "wgmma", "max_abs_err": err, "tol": tol,
               "plain_max_abs": ref.float().abs().max().item(), "dropped_halo_err": halo,
               "ms": cuda_ms(lambda: conv3x3_fused(k, b, x, relu=relu), reps=5),
               "plain_ms": cuda_ms(lambda: conv3x3_reference(k, b, x, relu=relu), reps=3),
               "library_ms": library_ms,
               "library": "F.conv2d (channels-last, same dtype, TF32 off)",
               "library_max_abs_diff": lib_diff,
               **roofline(2 * 9 * C * COUT * H * W * N,
                          N * H * W * (C + COUT) * elem + 9 * C * COUT * 4 + COUT * 4, dtype)}
        row["kernel_tflops"] = row["flop"] / row["ms"] / 1e9
        emit("conv3x3_vs_plain", **row)
        if ran_direct == uses_wgmma(x, COUT):
            fail(f"conv3x3 at {label} ran the {row['kernel']} kernel against its shape rule")
        if not bool(torch.isfinite(out).all().item()) or not err <= tol:
            fail(f"conv3x3 disagrees with its plain version at {label}: {err} > {tol}")
        for edge, cut in halo.items():
            if not cut > tol:
                fail(f"the conv3x3 bound at {label} ({tol}) would pass a dropped halo "
                     f"{edge} ({cut})")
        rows.append(row)
        del x, out, ref, lib, lib_out
        torch.cuda.empty_cache()
    return {"conv3x3": rows}


def probe_m(Sq: int, seed: int = 4) -> torch.Tensor:
    """The bisect's per-row shift m in [15, 16), f32 [6, Sq], from numpy (the
    same values on any device)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(15.0 + rng.random((6, Sq), dtype=np.float32))


def dropped_probe_tile_errors(kernel, variant, q, k, v, m, seq_k, o, lse) -> dict | None:
    """Max |Δ| of O (and lse) against the plain probe over all keys but the
    kernel's last 128-key tile: what a kernel that skipped or mis-masked that
    tile would show.  None where that tile is the only one or holds fewer
    than PROBE_DROP_MIN keys below seq_k (padding alone: for the masking
    modes it changes nothing)."""
    from da3slam_tpu_torch.ops import flash_probes as fp

    cut = (k.shape[1] - 1) // fp.KEY_TILE * fp.KEY_TILE
    if cut == 0 or seq_k - cut < PROBE_DROP_MIN:
        return None
    kc, vc = k[:, :cut].contiguous(), v[:, :cut].contiguous()
    if kernel == "flash_probe_nomax":
        o_cut, lse_cut = fp.flash_nomax_reference(q, kc, vc), None
    elif kernel == "flash_probe_bisect":
        o_cut, lse_cut = fp.flash_bisect_reference(q, kc, vc, variant, m, seq_k=cut)
    else:
        o_cut, lse_cut = fp.flash_lab_reference(q, kc, vc, variant, seq_k=cut), None
    out = {"o": (o.float() - o_cut.float()).abs().max().item()}
    if lse is not None:
        out["lse"] = (lse - lse_cut).abs().max().item()
    return out


def probe_lse_bound(q, k, lse_ref) -> torch.Tensor:
    """Per-row bound on the bisect's lse at the tile-edge lengths (LSE_TIP):
    LSE_TOL + LSE_TIP·p_max/l, where p_max/l = exp2(max_j s_ij − lse_i) (m
    cancels; the max over every key, padding included, errs on the large
    side)."""
    s_max = torch.stack([(q[b].float() @ k[b].float().T).amax(-1) for b in range(q.shape[0])])
    return LSE_TOL + LSE_TIP * torch.exp2(s_max - lse_ref)


def probe_jobs(q, k, v, m, seq_k):
    """(kernel, variant, kernel call, plain call, rows of f32 in/out, library
    call) for the constant-shift and bisect probes on one input.  O =
    softmax(ln2·q·kᵀ)·v for any shift, so SDPA with scale ln 2 is the
    library's call for O: over every key where the padding is counted (nomax,
    A, B), over the first seq_k where it is masked or subtracted (the padded v
    rows are zeros).  As for the production forwards, the lse output has no
    library call of its own."""
    from da3slam_tpu_torch.ops import flash_probes as fp

    Sk = k.shape[1]

    def sdpa_call(n):
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q[None], k[None, :, :n], v[None, :, :n], scale=0.6931471805599453)[0]

    jobs = [("flash_probe_nomax", "nomax", lambda: (fp.flash_nomax(q, k, v), None),
             lambda: (fp.flash_nomax_reference(q, k, v), None), 0, sdpa_call(Sk))]
    for var in sorted(fp.BISECT_VARIANTS):
        counted = fp.BISECT_VARIANTS[var][1] == "none"
        jobs.append(("flash_probe_bisect", var,
                     lambda var=var: fp.flash_bisect(q, k, v, var, m, seq_k=seq_k),
                     lambda var=var: fp.flash_bisect_reference(q, k, v, var, m, seq_k=seq_k),
                     1 if var == "A" else 2, sdpa_call(Sk if counted else seq_k)))
    return jobs


def phase_flash_probes() -> dict:
    """Each probe kernel in every mode against its plain version: O to
    2^-6·max|O| (bf16: the two round p at the same points and differ by the
    output's rounding), lse to 1e-3 (a dropped or double-counted key tile moves
    it by more), at the tools' shapes, a ragged one and the tile edges; the
    plain version without the last key tile breaks the bound of each mode."""
    from da3slam_tpu_torch.ops import flash_probes as fp
    from da3slam_tpu_torch.tools.flash_lab import lab_inputs
    from da3slam_tpu_torch.tools.flash_nomax_probe import probe_inputs

    rows = {"flash_probe_nomax": [], "flash_probe_bisect": [], "flash_probe_lab": []}
    checked = set()
    cases = [("tool", (PROBE_PAD, PROBE_PAD, PROBE_S)), ("ragged", PROBE_RAGGED)] + [
        (f"edge{Sq}x{Sk}s{seq_k}", (Sq, Sk, seq_k)) for Sq, Sk, seq_k in PROBE_EDGES]
    for case, (Sq, Sk, seq_k) in cases:
        # the tools' inputs (padded k, v rows zeros) and a per-row shift m in [15, 16)
        q, k, v = probe_inputs(Sq, Sk, "cuda", seed=4, seq_k=seq_k)
        m = probe_m(Sq).cuda()
        for kernel, var, run, plain, n_rows, library in probe_jobs(q, k, v, m, seq_k):
            edge = case.startswith("edge")
            rows[kernel].append(_probe_case(
                kernel, case, var, run, plain, library, probe_roofline(Sq, Sk, n_rows),
                (Sq, Sk, seq_k), edge and (
                    lambda o, lse, kernel=kernel, var=var: dropped_probe_tile_errors(
                        kernel, var, q, k, v, m, seq_k, o, lse)), checked,
                edge and (lambda lse_ref: probe_lse_bound(q, k, lse_ref))))
        del q, k, v, m
        torch.cuda.empty_cache()
    # the lab's q is as long as its padded keys
    lab_cases = [("tool", (LAB_S, LAB_S)), ("ragged", PROBE_RAGGED[1:])] + [
        (f"edge{Sk}s{seq_k}", (Sk, seq_k)) for Sq, Sk, seq_k in PROBE_EDGES if Sq == Sk]
    for case, (Sk, seq_k) in lab_cases:
        q, k, v = lab_inputs(Sk, "cuda", seed=4)
        for var in fp.LAB_VARIANTS:
            rows["flash_probe_lab"].append(_probe_case(
                "flash_probe_lab", case, var,
                lambda var=var: (fp.flash_lab(q, k, v, var, seq_k=seq_k), None),
                lambda var=var: (fp.flash_lab_reference(q, k, v, var, seq_k=seq_k), None),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None, :, :seq_k], v[None, :, :seq_k])[0],
                probe_roofline(Sk, seq_k, 0), (Sk, Sk, seq_k),
                case.startswith("edge") and (lambda o, lse, var=var: dropped_probe_tile_errors(
                    "flash_probe_lab", var, q, k, v, None, seq_k, o, lse)), checked))
        del q, k, v
        torch.cuda.empty_cache()
    modes = {(kernel, r["variant"]) for kernel, rs in rows.items() for r in rs}
    if modes - checked:
        fail(f"no shape held these probe modes to a dropped last key tile: {modes - checked}")
    return rows


def _probe_case(kernel, case, variant, run, plain, library, bound, shape, dropped,
                checked, lse_bound=None) -> dict:
    o, lse = run()
    o_ref, lse_ref = plain()
    torch.cuda.synchronize()
    err = (o.float() - o_ref.float()).abs().max().item()
    tol = fwd_bound(o_ref)
    lse_err = lse_excess = None
    lse_tol = LSE_TOL
    if lse is not None:
        lse_tol = lse_bound(lse_ref) if lse_bound else torch.full_like(lse_ref, LSE_TOL)
        lse_err = (lse - lse_ref).abs().max().item()
        lse_excess = ((lse - lse_ref).abs() - lse_tol).max().item()  # > 0: out of bound
        lse_tol = lse_tol.max().item()
    cut = dropped(o, lse) if dropped else None
    row = {"case": case, "variant": variant, "dtype": "bfloat16",
           "shape": dict(zip(("Sq", "Sk", "seq_k"), shape)), "max_abs_err": err, "tol": tol,
           "plain_max_abs": o_ref.float().abs().max().item(), "lse_max_abs_err": lse_err,
           "lse_tol": lse_tol, "dropped_tile_err": cut, "ms": cuda_ms(run, reps=5),
           "plain_ms": cuda_ms(plain, reps=3),
           "library_ms": cuda_ms(library, reps=5), "library": "F.scaled_dot_product_attention",
           # a yardstick of speed: it rounds p and O at other points, so it is
           # recorded beside the bound and not held to it
           "library_max_abs_diff": (library().float() - o_ref.float()).abs().max().item(),
           **bound}
    row["kernel_tflops"] = row["flop"] / row["ms"] / 1e9
    emit("probe_vs_plain", kernel=kernel, **row)
    if not bool(torch.isfinite(o).all().item()) or not err <= tol:
        fail(f"{kernel} {variant} disagrees with its plain version at {case}: {err} > {tol}")
    if lse_excess is not None and not lse_excess <= 0.0:
        fail(f"{kernel} {variant} lse disagrees with its plain version at {case}: {lse_err} "
             f"(beyond its bound by {lse_excess})")
    if cut is not None:
        if not (cut["o"] > tol or cut.get("lse", 0.0) > LSE_TOL):
            fail(f"the {kernel} {variant} bounds at {case} ({tol}, {LSE_TOL}) would pass a "
                 f"dropped last key tile ({cut})")
        checked.add((kernel, variant))
    return row


def int8_roofline(B: int, S: int, H: int, D: int) -> dict:
    """Roofline of the int8 kernel's function on ``[B, S, H, D]``: 4·B·H·S²·D
    integer operations at the int8 peak and B·H·S² exp2 on the
    special-function units (``PEAK_EXP2_PER_S``), against q8, k8, v8 in and O
    out (bf16) with the f32 row scales.  At twice the bf16 rate the products
    take half the exp2's time, so the exp2 bounds it (``bound_op``).  The
    kernel walks each block twice (6·S²·D products); the bound counts the
    function's 4."""
    r = roofline(4 * B * H * S * S * D, B * H * S * (3 * D + 2 * D + 4), torch.int8)
    exp2_ms = B * H * S * S / PEAK_EXP2_PER_S * 1e3
    r.update(bound_ms_ops=r["bound_ms"], exp2=B * H * S * S, exp2_floor_ms=exp2_ms,
             bound_op="int8")
    if exp2_ms > r["bound_ms"]:
        r.update(bound_ms=exp2_ms, bound_by="operations", bound_op="exp2")
    return r


def phase_int8_flash() -> dict:
    """The int8 probe kernel against its plain version (bound: see INT8_CASES),
    and both against f32 softmax attention (the algorithm's own error).  ``ms``
    is the kernel alone (``int8_attention`` on inputs quantized once);
    ``wrapper_ms`` the whole ``int8_flash`` call, ``quantize_ms`` and
    ``layout_ms`` the tensor code inside it."""
    from da3slam_tpu_torch.ops.int8_flash import (
        effective_block_k,
        int8_attention,
        int8_flash,
        int8_flash_reference,
        quantize_qkv,
        value_layout,
    )
    from da3slam_tpu_torch.tools.int8_flash_probe import int8_inputs, softmax_attention

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for label, dtype, shape, block_k in INT8_CASES:
        B, S, H, D = shape
        if B == 1:  # the tool's own inputs: its softmax limit is stated for them
            q, k, v = int8_inputs(S, H, "cuda", dtype)
        else:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                       for _ in range(3))
        o = int8_flash(q, k, v, block_k=block_k)
        ref = int8_flash_reference(q, k, v, block_k)
        torch.cuda.synchronize()
        err = (o.float() - ref.float()).abs().max().item()
        bit_equal = (o == ref).float().mean().item()
        tol = fwd_bound(ref)
        bk = effective_block_k(S, block_k)
        last = (-(-S // bk) - 1) * bk
        dropped = {}
        for what, drop in (("key_tile", (64, 128)), ("last_block", (last, last + bk))):
            cut = int8_flash_reference(q, k, v, block_k, drop=drop)
            dropped[what] = (cut.float() - ref.float()).abs().max().item()
            del cut
        soft = softmax_attention(q, k, v)
        soft_err = (o.float() - soft).abs().max().item()
        soft_rel = soft_err / soft.abs().max().item()
        del soft
        q8, k8, v8, sq, sk, _, _ = quantize_qkv(q, k, v, block_k)
        vt = value_layout(v8)
        ms = cuda_ms(lambda: int8_attention(q8, k8, vt, sq, sk, S, bk), reps=5)
        row = {"case": label, "dtype": str(dtype).replace("torch.", ""), "shape": list(shape),
               "block_k": block_k, "max_abs_err": err, "tol": tol, "bit_equal_share": bit_equal,
               "plain_max_abs": ref.float().abs().max().item(), "dropped_err": dropped,
               "softmax_max_abs_err": soft_err, "softmax_rel_err": soft_rel,
               "ms": ms, "wrapper_ms": cuda_ms(lambda: int8_flash(q, k, v, block_k=block_k),
                                               reps=5),
               # the tensor code inside ``wrapper_ms``, timed apart
               "quantize_ms": cuda_ms(lambda: quantize_qkv(q, k, v, block_k), reps=3),
               "layout_ms": cuda_ms(lambda: value_layout(v8), reps=3),
               "plain_ms": cuda_ms(lambda: int8_flash_reference(q, k, v, block_k), reps=1),
               "library_ms": None, "library": None, **int8_roofline(B, S, H, D)}
        row["kernel_tops"] = row["flop"] / ms / 1e9
        emit("int8_flash_vs_plain", **row, gpu=gpu_state())
        if not bool(torch.isfinite(o).all().item()) or not err <= tol:
            fail(f"int8_flash disagrees with its plain version at {label}: {err} > {tol}")
        for what, cut_err in dropped.items():
            if not cut_err > tol:
                fail(f"the int8_flash bound at {label} ({tol}) would pass a dropped {what} "
                     f"({cut_err})")
        if label == "check" and not soft_rel < INT8_SOFTMAX_REL_TOL:
            fail(f"int8_flash is {soft_rel} of the output's range from softmax attention at "
                 f"the check shape (limit {INT8_SOFTMAX_REL_TOL})")
        rows.append(row)
        del q, k, v, o, ref, q8, k8, v8, vt
        torch.cuda.empty_cache()
    return {"int8_flash_fwd": rows}


def phase_tools(path_launches: dict) -> None:
    """The five probe tools through their ``main``: every row that carries a
    kernel's error against its plain version is held here to the bounds of the
    phases above, and the int8 tool's check case to its own limit."""
    from da3slam_tpu_torch.tools import flash_bound_bisect, flash_lab, flash_nomax_probe
    from da3slam_tpu_torch.tools import int8_flash_probe, probe_conv3x3

    with counted(path_launches, "tools"):
        t0 = time.perf_counter()
        out = {"probe_conv3x3": probe_conv3x3.main([]),
               "flash_nomax_probe": flash_nomax_probe.main(["1024,3584"]),
               "flash_bound_bisect": flash_bound_bisect.main(["A", "C", "E"]),
               "flash_lab": flash_lab.main([]),
               "int8_flash_probe": int8_flash_probe.main([]) + int8_flash_probe.main(["--check"])}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches["tools"]
    emit("tools", wall_s=wall, launches=launches, rows=out)
    for name in ("conv3x3", "flash_probe_nomax", "flash_probe_bisect", "flash_probe_lab",
                 "int8_flash_fwd"):
        if not launches[name]:
            fail(f"tools: {name} was launched no time")
    # the int8 tool times the production bound forward beside its kernel
    if any(launches[name] for name in launches
           if name.startswith("flash_attn") and name != "flash_attn_bound_fwd"):
        fail(f"tools: a production kernel was launched: {launches}")
    for tool, rows in out.items():
        for row in rows:
            if "max_abs_err" not in row:
                continue  # an accuracy or time line without a plain-version comparison
            tol = BF16_REL_TOL * row["plain_max_abs"]
            if not row["max_abs_err"] <= tol or not row.get("lse_max_abs_err", 0.0) <= LSE_TOL:
                fail(f"tools: {tool} reports {row}")


def read_ply(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """Vertices and colors of a binary PLY as ``inout/ply.py:write_ply`` writes it."""
    data = path.read_bytes()
    head, _, body = data.partition(b"end_header\n")
    n = int(next(ln.split()[2] for ln in head.decode("ascii").splitlines()
                 if ln.startswith("element vertex")))
    rec = np.frombuffer(body, dtype=[("xyz", "<f4", 3), ("rgb", np.uint8, 3)], count=n)
    return rec["xyz"], rec["rgb"]


def phase_main_align(path_launches: dict) -> None:
    from da3slam_tpu_torch.cli import main_align

    ply = WORK / "align" / "fused.ply"
    args = ["--image_dir", str(frames_dir()), *ALIGN_ARGS, "--output_ply", str(ply)]
    out = io.StringIO()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "main_align"):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            main_align.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(out.getvalue(), end="", flush=True)
    stats = [[float(x) for x in ln.replace("=", " ").split()[3::2]]
             for ln in out.getvalue().splitlines() if ln.startswith("chunk ")]
    launches = path_launches["main_align"]
    expected = expected_launches(flash_attn_bound_fwd=ALIGN_EXPECTED_LAUNCHES)
    pts, cols = read_ply(ply)
    emit("main_align", args=ALIGN_ARGS, frames=N_FRAMES, wall_s=wall,
         frames_per_s=N_FRAMES / wall,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         chunk_stats_scale_fitness_rmse=stats, ply_points=int(len(pts)),
         ply_finite=bool(np.isfinite(pts).all()), kernel_launches=launches,
         expected_launches=expected)
    if len(stats) != 2 or not np.isfinite(np.array(stats)).all():
        fail(f"main_align: chunk diagnostics {stats}")
    if len(pts) == 0 or not np.isfinite(pts).all() or cols.shape != pts.shape:
        fail(f"main_align: PLY with {len(pts)} points, finite={np.isfinite(pts).all()}")
    if launches != expected:
        fail(f"kernel launches on the main_align path: {launches} != {expected}")


def phase_w8a8(path_launches: dict) -> None:
    """One LARGE chunk (15 frames at 504², bf16, random weights from a seed)
    through ``model.quantize()`` against the float model it was made from:
    outputs finite and within tests/test_quant.py's limits, 24 bound-forward
    launches and no other kernel; chunk times in turns (float, w8a8, w8a8,
    float); then where one warm chunk's device time goes, for each."""
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.models.vit import Int8Linear

    model = DepthAnything3.from_pretrained("large", device="cuda")
    qmodel = model.quantize()
    n_int8 = sum(isinstance(m, Int8Linear) for m in qmodel.net.modules())
    frames = make_frames(15, seed=1)
    torch.cuda.synchronize()
    with counted(path_launches, "w8a8"):
        pred_q = qmodel.inference(image=frames)
        torch.cuda.synchronize()
    launches = path_launches["w8a8"]
    expected = expected_launches(flash_attn_bound_fwd=model.cfg.depth)
    pred_f = model.inference(image=frames)
    finite = all(bool(np.isfinite(getattr(pred_q, f)).all())
                 for f in ("depth", "conf", "extrinsics", "intrinsics"))
    depth_rel = float(np.linalg.norm(pred_q.depth - pred_f.depth)
                      / max(np.linalg.norm(pred_f.depth), 1e-9))
    ext_err = float(np.abs(pred_q.extrinsics - pred_f.extrinsics).max())
    chunk_ms = [(tag, cuda_ms(lambda m=m: m.inference(image=frames, keep_on_device=True), reps=2))
                for tag, m in (("float", model), ("w8a8", qmodel), ("w8a8", qmodel),
                               ("float", model))]
    emit("w8a8", preset="large", frames=15, dtype="bfloat16", int8_linears=n_int8,
         float_model_untouched=not any(isinstance(m, Int8Linear) for m in model.net.modules()),
         finite=finite, depth_rel_l2=depth_rel, depth_tol=W8A8_DEPTH_REL_TOL,
         extrinsics_max_abs_diff=ext_err, extrinsics_tol=W8A8_EXT_TOL,
         chunk_ms_in_turns=chunk_ms, kernel_launches=launches, expected_launches=expected)
    if n_int8 != 3 * model.cfg.depth:
        fail(f"w8a8: {n_int8} quantized projections, expected {3 * model.cfg.depth}")
    if not finite or not depth_rel <= W8A8_DEPTH_REL_TOL or not ext_err <= W8A8_EXT_TOL:
        fail(f"w8a8: finite={finite}, depth rel L2 {depth_rel}, extrinsics {ext_err}")
    if launches != expected:
        fail(f"kernel launches on the w8a8 path: {launches} != {expected}")
    # the QKV product alone (19515 x 1024 x 3072): torch._int_mm with w8 in
    # quantize_weight's column-major layout and row-major, beside the bf16 GEMM
    gen = torch.Generator(device="cuda").manual_seed(6)
    x8 = torch.randint(-127, 128, (15 * 1301, 1024), generator=gen, device="cuda",
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (3072, 1024), generator=gen, device="cuda", dtype=torch.int8)
    xb, wb = x8.bfloat16(), w8.t().bfloat16().contiguous()
    emit("int8_gemm", shape=[15 * 1301, 1024, 3072],
         int_mm_column_major_ms=cuda_ms(lambda: torch._int_mm(x8, w8.t()), reps=5),
         int_mm_row_major_ms=cuda_ms(lambda: torch._int_mm(x8, w8.t().contiguous()), reps=5),
         bf16_matmul_ms=cuda_ms(lambda: xb @ wb, reps=5))
    # where one warm LARGE chunk's device time goes
    _profile("large_chunk_profile", lambda: model.inference(image=frames, use_ray_pose=True),
             preset="large", frames=15, dtype="bfloat16")
    _profile("w8a8_chunk_profile", lambda: qmodel.inference(image=frames, use_ray_pose=True),
             preset="large", frames=15, dtype="bfloat16 activations, int8 QKV and MLP GEMMs")
    del model, qmodel
    torch.cuda.empty_cache()


def _sync_warnings(caught) -> int:
    return sum("synchroniz" in str(w.message) for w in caught)


def _count_syncs(fn, where: dict | None = None) -> int:
    """How many times ``fn`` made the host wait for the device, as
    ``torch.cuda.set_sync_debug_mode`` reports it; ``where`` (if given)
    receives the count by the Python line each wait was reported at."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    if where is not None:
        for w in caught:
            if "synchroniz" in str(w.message):
                key = f"{Path(w.filename).name}:{w.lineno}"
                where[key] = where.get(key, 0) + 1
    return _sync_warnings(caught)


def solver_split(config: dict) -> dict:
    """``SLAMSolver`` built and run over the generated frames as
    ``cli/main_slam.main`` builds and runs it, with the host's waits for the
    device counted apart for its three parts: the load (the constructor: the
    model made on the CPU and moved to the card, one blocking copy a tensor),
    the loop (``run()`` up to ``_materialize``: PNG decode, inference and
    alignment of every chunk) and the final fetch (``_materialize``).  The
    load and the run are timed apart too; ``run_frames_per_s`` is the run's
    rate with the model resident, PNG decode included."""
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    marks = {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            solver = SLAMSolver(str(frames_dir()), config, viewer=None,
                                device=torch.device("cuda"))
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            marks["load"] = _sync_warnings(caught)
            fetch = solver._materialize

            def counted_fetch():
                marks["loop"] = _sync_warnings(caught) - marks["load"]
                fetch()

            solver._materialize = counted_fetch
            torch.cuda.set_sync_debug_mode("warn")
            solver.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        marks["fetch"] = _sync_warnings(caught) - marks["load"] - marks["loop"]
        # the Python lines the waits after the load were reported at
        where: dict[str, int] = {}
        for w in [w for w in caught if "synchroniz" in str(w.message)][marks["load"]:]:
            key = f"{Path(w.filename).name}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    poses, _ = solver.trajectory()
    return {"host_syncs": marks, "loop_and_fetch_syncs_at": where, "load_s": t1 - t0,
            "run_s": t2 - t1,
            "run_frames_per_s": N_FRAMES / (t2 - t1), "poses": poses}


def phase_main_slam_irls(path_launches: dict) -> dict:
    """The main path again from a config file: device-resident solver, IRLS
    alignment with the config's IRLS block, the prefetcher staging each next
    chunk's upload on its side stream; for IRLS with and without the
    prefetcher and for ICP.  Each configuration runs twice.  Once whole,
    through ``main_slam.main``: launch counts, wall time and every host wait,
    which includes building SMALL on the CPU and moving it to the card (one
    blocking copy a parameter tensor).  Once split (``solver_split``): the
    waits of the load, the loop and the final fetch apart.  The
    device-resident ICP loop must not wait at all, IRLS may add its
    ``torch.linalg.svd``s and ``det``s (IRLS_LOOP_SYNCS), the final fetch is
    one transfer, and both runs give the same trajectory."""
    from da3slam_tpu_torch.cli import main_slam
    from da3slam_tpu_torch.inout import load_config

    def run(tag: str, method: str, prefetch: bool) -> dict:
        cfg = WORK / f"slam_{tag}.yaml"
        cfg.write_text(
            "Weights: {DA3: small}\n"
            f"Model: {{chunk_size: 15, overlap_size: 1, keyframe_interval: 1, "
            f"device_resident: true, prefetch: {str(prefetch).lower()}}}\n"
            f"Align: {{method: {method}}}\n"
            "IRLS: {delta: 0.1, max_iters: 5, tol: 1.e-9}\n")
        out_dir = WORK / f"out_{tag}"
        torch.cuda.synchronize()
        with counted(path_launches, f"main_slam_{tag}"):
            t0 = time.perf_counter()
            syncs = _count_syncs(lambda: main_slam.main(
                ["--image_dir", str(frames_dir()), "--config", str(cfg),
                 "--output_dir", str(out_dir), "--headless"]))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
        launches = path_launches[f"main_slam_{tag}"]
        if poses.shape != (N_FRAMES, 16) or not np.isfinite(poses).all():
            fail(f"main_slam {tag}: poses {poses.shape}, finite={np.isfinite(poses).all()}")
        if launches != expected_launches(flash_attn_bound_fwd=EXPECTED_LAUNCHES):
            fail(f"main_slam {tag}: launches {launches}")
        split = solver_split(load_config(str(cfg)))
        split["vs_whole_run_max_abs_diff"] = float(
            np.abs(split.pop("poses").reshape(N_FRAMES, 16) - poses).max())
        if not split["vs_whole_run_max_abs_diff"] <= PIPELINE_TOL:
            fail(f"main_slam {tag}: the split run's trajectory differs from the whole run's "
                 f"by {split['vs_whole_run_max_abs_diff']}")
        return {"method": method, "prefetch_and_staging": prefetch, "wall_s": wall,
                "host_syncs": syncs, "poses_shape": list(poses.shape),
                "bound_launches": launches["flash_attn_bound_fwd"], "split": split}

    runs = {"irls": run("irls", "irls", True),
            "irls_no_prefetch": run("irls_no_prefetch", "irls", False),
            "icp": run("icp", "icp", True)}
    loop = {tag: r["split"]["host_syncs"]["loop"] for tag, r in runs.items()}
    emit("main_slam_irls", frames=N_FRAMES, runs=runs,
         loop_syncs_limit={"icp": ICP_LOOP_SYNCS, "irls_over_icp": IRLS_LOOP_SYNCS},
         syncs_irls_adds_over_icp=runs["irls"]["host_syncs"] - runs["icp"]["host_syncs"],
         syncs_staging_adds=runs["irls"]["host_syncs"] - runs["irls_no_prefetch"]["host_syncs"])
    if loop["icp"] > ICP_LOOP_SYNCS:
        fail(f"main_slam icp: the device-resident loop made the host wait {loop['icp']} times "
             f"(limit {ICP_LOOP_SYNCS})")
    for tag in ("irls", "irls_no_prefetch"):
        if loop[tag] - loop["icp"] > IRLS_LOOP_SYNCS:
            fail(f"main_slam {tag}: IRLS adds {loop[tag] - loop['icp']} host waits to the loop "
                 f"(limit {IRLS_LOOP_SYNCS})")
    for tag, r in runs.items():
        if r["split"]["host_syncs"]["fetch"] > 1:
            fail(f"main_slam {tag}: the final fetch made {r['split']['host_syncs']['fetch']} "
                 "transfers, not one")
    return runs


def loop_frames_dir() -> Path:
    """``make_frames(36)`` and the same frames in reverse: 72 518² PNGs."""
    from PIL import Image

    image_dir = WORK / "loop_frames"
    if not image_dir.exists():
        image_dir.mkdir(parents=True)
        frames = make_frames(LOOP_FRAMES // 2, seed=2)
        for i, f in enumerate(np.concatenate([frames, frames[::-1]])):
            Image.fromarray(f).save(image_dir / f"{i:06d}.png", compress_level=1)
    return image_dir


def _pose_graph(K: int, seed: int, device: str):
    """A chain of K Sim(3) nodes with drifted odometry (2% noise) and two
    exact loop edges, made on the CPU from a seed and moved to ``device``:
    (ground-truth nodes, initial nodes, edges)."""
    from da3slam_tpu_torch.core.transforms import Sim3, sim3_compose, sim3_inverse, so3_exp
    from da3slam_tpu_torch.ops.posegraph import add_loop_edges, sequential_edges

    gen = np.random.default_rng(seed)

    def rand(s_spread, t_spread, w_spread):
        return Sim3(torch.tensor(float(np.exp(gen.normal() * s_spread))),
                    so3_exp(torch.tensor(gen.normal(size=3) * w_spread, dtype=torch.float32)),
                    torch.tensor(gen.normal(size=3) * t_spread, dtype=torch.float32))

    nodes = [Sim3(torch.tensor(1.0), torch.eye(3), torch.zeros(3))]
    for _ in range(K - 1):
        nodes.append(sim3_compose(nodes[-1], rand(0.2, 0.5, 0.3)))
    noisy = [sim3_compose(sim3_compose(sim3_inverse(nodes[k]), nodes[k + 1]),
                          rand(0.02, 0.02, 0.02)) for k in range(K - 1)]
    init = [nodes[0]]
    for m in noisy:
        init.append(sim3_compose(init[-1], m))

    def dev(T):
        return Sim3(*(x.to(device) for x in T))

    def stack(Ts):
        return Sim3(*(torch.stack(parts).to(device) for parts in zip(*Ts)))

    loops = [(a, b, dev(sim3_compose(sim3_inverse(nodes[a]), nodes[b])))
             for a, b in ((0, K - 1), (2, K // 2))]
    edges = add_loop_edges(sequential_edges([dev(m) for m in noisy]), loops, weight=3.0)
    return stack(nodes), stack(init), edges


def loop_synthetic_config(enable: bool) -> dict:
    """tests/test_torch_loop.py's live-solver configuration, device-resident."""
    return {
        "Model": {"chunk_size": 6, "overlap_size": 1, "keyframe_interval": 1,
                  "sleep_between_chunk": 0, "device_resident": True},
        "Loop": {"enable": enable, "stride": 2,
                 "Retrieval": {"threshold": 0.9, "min_gap": 25, "max_loops": 5},
                 "Gate": {"max_rmse": 0.08, "min_n_effective": 200, "max_reciprocal_err": 0.15},
                 "SIM3_Optimizer": {"max_iterations": 30, "lambda_init": 1e-6}},
    }


def phase_loop_closure() -> None:
    """The pose graph and the live solver's loop closure on the card, each
    against the same run on the CPU.

    ``optimize_sim3_pose_graph`` over a drifted chain with two exact loop
    edges, 30 LM iterations: dense over 16 nodes, CG over 6 (each CG
    iteration is a ``jvp`` and a ``vjp`` of the residual, many small
    launches: the 16-node CG solve took 52 s on an H100):
    the card's nodes against the CPU's (POSEGRAPH_TOL), the host's waits for
    the device and the time.

    ``SLAMSolver(device="cuda")`` over the 48-frame synthetic loop
    (``utils/synthetic.py``, chunks of 6), closure off and on, twice: with
    the revisits rendered as they were first seen, and with a gamma drift
    over the sequence (``brightness_drift`` 0.35: a revisit is seen under
    other light).  Each needs an accepted loop edge and ATE on below ATE off
    (the ported ``evaluate_trajectory`` on the card).  Without the drift the
    revisits' thumbnails tie at a similarity of 1, and which of the tied
    pairs non-maximum suppression keeps follows the product's summation
    order (on the CPU as in the JAX package): the card's edges are reported
    beside the CPU's, not held to them.  With the drift there is no tie:
    the card's edges must be the CPU's and its poses within
    LOOP_SOLVER_REL_TOL of the scene extent of the CPU run's.  The host's
    waits of each loop-on run are counted (the synthetic model's numpy
    outputs are uploaded every chunk, which the loop-off run shows)."""
    from da3slam_tpu_torch.ops.posegraph import optimize_sim3_pose_graph
    from da3slam_tpu_torch.slam.evaluate import evaluate_trajectory
    from da3slam_tpu_torch.slam.solver import SLAMSolver
    from da3slam_tpu_torch.utils import synthetic

    graphs = {}
    for solver, nodes in (("dense", 16), ("cg", 6)):
        out, syncs, secs = {}, {}, {}
        for device in ("cpu", "cuda"):
            gt, init, edges = _pose_graph(nodes, seed=5, device=device)
            box = {}

            def run(init=init, edges=edges, box=box, solver=solver):
                box["out"] = optimize_sim3_pose_graph(init, edges, max_iterations=30,
                                                      solver=solver)

            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if device == "cuda":
                syncs[device] = _count_syncs(run, where := {})
            else:
                run()
            torch.cuda.synchronize()
            secs[device] = time.perf_counter() - t0
            out[device] = [x.cpu() for x in box["out"]]
        err = max((a - b).abs().max().item() for a, b in zip(out["cuda"], out["cpu"]))
        drift = {"init": (init.t[-1].cpu() - gt.t[-1].cpu()).norm().item(),
                 "optimized": (out["cuda"][2][-1] - gt.t[-1].cpu()).norm().item()}
        graphs[solver] = {"nodes": nodes, "max_abs_err_vs_cpu": err,
                          "tol": POSEGRAPH_TOL[solver], "host_syncs_cuda": syncs["cuda"],
                          "host_syncs_at": where,
                          "s_cuda": secs["cuda"], "s_cpu": secs["cpu"], "last_node_drift": drift}
        if not err <= POSEGRAPH_TOL[solver]:
            fail(f"pose graph ({solver}): card and CPU differ by {err} > {POSEGRAPH_TOL[solver]}")
        if not drift["optimized"] < 0.5 * drift["init"]:
            fail(f"pose graph ({solver}): drift {drift} not corrected")

    n = 48
    poses = synthetic.make_loop_trajectory(n)
    gt_c2w = np.stack([np.linalg.inv(np.vstack([E, [0, 0, 0, 1]])) for E in poses])
    extent = float(np.abs(gt_c2w[:, :3, 3]).max())
    image_dir = synthetic.make_synthetic_image_dir(WORK / "loop_synthetic", n)
    rows = {}
    for drift in (0.0, 0.35):
        runs = {}
        for device, enable in (("cpu", True), ("cuda", False), ("cuda", True)):
            rng = np.random.default_rng(3)
            model = synthetic.SyntheticDA3(poses, hw=(48, 64),
                                           chunk_scales=rng.uniform(0.5, 2.0, size=24),
                                           depth_noise=6e-3, textured=True, seed=7,
                                           brightness_drift=drift)
            solver = SLAMSolver(image_dir, loop_synthetic_config(enable), model=model,
                                device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            syncs, where = None, {}
            if device == "cuda":
                syncs = _count_syncs(solver.run, where)
            else:
                solver.run()
            torch.cuda.synchronize()
            c2w = solver.trajectory()[0]
            runs[device, enable] = {
                "c2w": c2w, "s": time.perf_counter() - t0, "host_syncs": syncs, "where": where,
                "chunks": len(solver.results), "loop_s": solver.timer.totals.get("loop"),
                "edges": [(a, b) for a, b, _ in solver.loop_closer.loop_edges] if enable else [],
                "ate": evaluate_trajectory(c2w, gt_c2w, align="sim3", device=device).ate_rmse}
        on, off, cpu_on = runs["cuda", True], runs["cuda", False], runs["cpu", True]
        pose_err = float(np.abs(on["c2w"] - cpu_on["c2w"]).max())
        rows[drift] = {
            "brightness_drift": drift, "frames": n, "chunks": on["chunks"], "edges": on["edges"],
            "cpu_edges": cpu_on["edges"], "ate_on": on["ate"], "ate_off": off["ate"],
            "cpu_ate_on": cpu_on["ate"], "max_abs_pose_err_vs_cpu": pose_err,
            "tol": LOOP_SOLVER_REL_TOL * extent, "held_to_cpu": drift > 0,
            "host_syncs_on": on["host_syncs"], "host_syncs_off": off["host_syncs"],
            "host_syncs_on_per_chunk": on["host_syncs"] / on["chunks"],
            "host_syncs_on_at": on["where"], "host_syncs_off_at": off["where"],
            "loop_stage_s": on["loop_s"],
            "s_on": on["s"], "s_off": off["s"], "s_cpu_on": cpu_on["s"]}
    emit("loop_closure", pose_graph=graphs, solver=list(rows.values()))
    for drift, row in rows.items():
        if not row["edges"] or not row["ate_on"] < row["ate_off"]:
            fail(f"loop closure (drift {drift}): edges {row['edges']}, ATE on {row['ate_on']} "
                 f"against off {row['ate_off']}")
        if row["held_to_cpu"] and (row["edges"] != row["cpu_edges"]
                                   or not row["max_abs_pose_err_vs_cpu"] <= row["tol"]):
            fail(f"loop closure (drift {drift}): card edges {row['edges']} against the CPU's "
                 f"{row['cpu_edges']}, poses differ by {row['max_abs_pose_err_vs_cpu']}")


def _attempts(rows) -> list[dict]:
    """(a, b, similarity, LoopConstraint, accepted) → JSON-ready rows."""
    return [{"chunks": [a, b], "similarity": sim, "rmse": lc.rmse,
             "n_effective": lc.n_effective, "reciprocal_err": lc.reciprocal_err,
             "accepted": accepted} for a, b, sim, lc, accepted in rows]


def phase_main_slam_loop(path_launches: dict) -> None:
    """``cli/main_slam`` at SMALL with a ``Loop`` block, device-resident, over
    the 72 revisiting frames (chunks of 15): 72 finite poses, at least one
    joint re-inference, 12 bound-forward launches a chunk and a joint
    re-inference; the similarity and gate numbers of each constraint, frames/s
    (building SMALL included), the host's waits and peak memory."""
    from da3slam_tpu_torch.cli import main_slam

    image_dir = loop_frames_dir()
    cfg = WORK / "slam_loop.yaml"
    cfg.write_text("Weights: {DA3: small}\n"
                   "Model: {chunk_size: 15, overlap_size: 1, keyframe_interval: 1, "
                   "device_resident: true}\n" + LOOP_BLOCK)
    out_dir = WORK / "out_loop"
    box = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    with counted(path_launches, "main_slam_loop"):
        t0 = time.perf_counter()
        syncs = _count_syncs(lambda: box.setdefault("solver", main_slam.main(
            ["--image_dir", str(image_dir), "--config", str(cfg),
             "--output_dir", str(out_dir), "--headless"])), where := {})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    closer = box["solver"].loop_closer
    attempts = _attempts(closer.attempts)
    launches = path_launches["main_slam_loop"]
    expected = expected_launches(flash_attn_bound_fwd=12 * (LOOP_CHUNKS + len(attempts)))
    poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
    emit("main_slam_loop", frames=LOOP_FRAMES, chunks=len(box["solver"].results),
         joint_reinferences=len(attempts), joint_views=30, joint_seq_len=30 * 1301,
         attempts=attempts, accepted_edges=[[a, b] for a, b, _ in closer.loop_edges],
         wall_s=wall, frames_per_s=LOOP_FRAMES / wall,
         wall_includes="building SMALL on the CPU, its upload, PNG decode, export",
         host_syncs=syncs, host_syncs_at=where, timer_s=box["solver"].timer.totals,
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         poses_shape=list(poses.shape), poses_finite=bool(np.isfinite(poses).all()),
         kernel_launches=launches, expected_launches=expected)
    if poses.shape != (LOOP_FRAMES, 16) or not np.isfinite(poses).all():
        fail(f"main_slam_loop: poses {poses.shape}, finite={np.isfinite(poses).all()}")
    if not attempts:
        fail("main_slam_loop: no joint re-inference ran")
    if launches != expected:
        fail(f"main_slam_loop: launches {launches} != {expected}")


def phase_streaming(path_launches: dict) -> None:
    """``cli/streaming`` at SMALL over the 72 revisiting frames with the CLI's
    default chunks (16, overlap 4: six chunks, the last re-anchored on
    (56, 72)), a ``Loop`` block, ``--traj_formats tum,kitti`` and ``--mesh``:
    72 finite poses in each trajectory file, a finite ``combined_pcd.ply``, a
    finite ``scene_mesh.ply`` (the TSDF fusion at resolution 192, sparse, its
    ``save_mesh`` timed apart), at least one joint re-inference (S = 41632),
    12 bound-forward launches a chunk and a joint re-inference; frames/s
    (building SMALL included) and peak memory.  Random weights may leave no
    surface (the mesh export then writes nothing, as the JAX package's), so
    the mesh itself is held on the synthetic room (``streaming_mesh_room``)."""
    from da3slam_tpu_torch.cli import streaming
    from da3slam_tpu_torch.inout.mesh import read_mesh_ply
    from da3slam_tpu_torch.inout.ply import read_ply as port_read_ply
    from da3slam_tpu_torch.slam.streaming import DA3Streaming

    image_dir = loop_frames_dir()
    cfg = WORK / "stream_loop.yaml"
    cfg.write_text("Weights: {DA3: small}\n" + LOOP_BLOCK)
    out_dir = WORK / "stream_out"
    save_mesh, mesh_s = DA3Streaming.save_mesh, []

    def timed_save_mesh(self):
        torch.cuda.synchronize()
        t = time.perf_counter()
        save_mesh(self)
        torch.cuda.synchronize()
        mesh_s.append(time.perf_counter() - t)

    DA3Streaming.save_mesh = timed_save_mesh
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    try:
        with counted(path_launches, "streaming"):
            t0 = time.perf_counter()
            run = streaming.main(["--image_dir", str(image_dir), "--config", str(cfg),
                                  "--output_dir", str(out_dir), "--traj_formats", "tum,kitti",
                                  "--mesh"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        DA3Streaming.save_mesh = save_mesh
    attempts = _attempts(run.loop_attempts)
    launches = path_launches["streaming"]
    expected = expected_launches(flash_attn_bound_fwd=12 * (LOOP_CHUNKS + len(attempts)))
    files = {name: np.loadtxt(out_dir / name, ndmin=2) for name in
             ("camera_poses.txt", "camera_poses_tum.txt", "camera_poses_kitti.txt")}
    pts, cols = port_read_ply(out_dir / "combined_pcd.ply")
    mesh = out_dir / "scene_mesh.ply"
    verts, faces = read_mesh_ply(mesh) if mesh.exists() else (np.zeros((0, 3)), np.zeros((0, 3)))
    emit("streaming", frames=LOOP_FRAMES, chunk_ranges=run.chunk_ranges,
         joint_reinferences=len(attempts), joint_views=32, joint_seq_len=32 * 1301,
         attempts=attempts, accepted_edges=[[a, b] for a, b, _ in run.loop_edges],
         wall_s=wall, frames_per_s=LOOP_FRAMES / wall,
         wall_includes="building SMALL on the CPU, its upload, PNG decode, spills, PLYs, "
                       "the mesh",
         save_mesh_s=mesh_s, mesh_resolution=run.mesh_resolution, mesh_sparse=run.mesh_sparse,
         mesh_block_budget=run._mesh_block_budget, mesh_vertices=int(len(verts)),
         mesh_faces=int(len(faces)), mesh_finite=bool(np.isfinite(verts).all()),
         max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
         poses_shapes={k: list(v.shape) for k, v in files.items()},
         ply_points=int(len(pts)), ply_finite=bool(np.isfinite(pts).all()),
         pose_filled=run.n_pose_filled, kernel_launches=launches, expected_launches=expected)
    for name, rows in files.items():
        if rows.shape[0] != LOOP_FRAMES or not np.isfinite(rows).all():
            fail(f"streaming: {name} {rows.shape}, finite={np.isfinite(rows).all()}")
    if len(pts) == 0 or not np.isfinite(pts).all() or cols is None:
        fail(f"streaming: combined_pcd.ply with {len(pts)} points, finite={np.isfinite(pts).all()}")
    if not np.isfinite(verts).all() or len(mesh_s) != 1 or run._mesh_block_budget is None:
        fail(f"streaming: scene_mesh.ply with {len(verts)} vertices, "
             f"finite={np.isfinite(verts).all()}, save_mesh ran {len(mesh_s)} times, "
             f"budget {run._mesh_block_budget}")
    if len(run.chunk_ranges) != LOOP_CHUNKS or run.chunk_ranges[-1] != (56, 72):
        fail(f"streaming: chunks {run.chunk_ranges}")
    if not attempts:
        fail("streaming: no joint re-inference ran")
    if launches != expected:
        fail(f"streaming: launches {launches} != {expected}")


def phase_streaming_mesh_room() -> None:
    """``DA3Streaming`` with ``export_mesh`` on the card over the synthetic
    corner room (``utils/synthetic.py``'s model: 9 frames in chunks of 4,
    overlap 2, chunk scales 1.4 / 0.8 / 1.1), sparse and dense: the mesh lies
    on the chunk-0-scaled planes (90% of vertices within 0.2·s0, the CPU
    test's bound) and has the CPU run's vertex count within 2%."""
    from da3slam_tpu_torch.inout.mesh import read_mesh_ply
    from da3slam_tpu_torch.slam.streaming import DA3Streaming
    from da3slam_tpu_torch.utils import synthetic as syn

    poses, scales = syn.make_trajectory(9), [1.4, 0.8, 1.1]
    image_dir = syn.make_synthetic_image_dir(WORK / "room", 9)
    rows = {}
    for sparse in (True, False):
        verts = {}
        for device in ("cuda", "cpu"):
            out = WORK / f"room_{sparse}_{device}"
            cfg = {"Model": {"chunk_size": 4, "overlap": 2, "export_mesh": True,
                             "mesh_resolution": 64, "mesh_sparse": sparse}}
            DA3Streaming(image_dir, str(out), cfg, device=device,
                         model=syn.SyntheticDA3(poses, chunk_scales=scales)).run()
            verts[device] = read_mesh_ply(out / "scene_mesh.ply")[0]
        v = verts["cuda"]
        dists = np.min(np.stack([np.abs(v @ np.asarray(n) - c * scales[0])
                                 for n, c in syn.PLANES]), axis=0)
        rows["sparse" if sparse else "dense"] = {
            "vertices": int(len(v)), "cpu_vertices": int(len(verts["cpu"])),
            "p90_plane_dist": float(np.quantile(dists, 0.9)), "bound": 0.2 * scales[0]}
    emit("streaming_mesh_room", frames=9, resolution=64, runs=rows)
    for mode, r in rows.items():
        if not (r["vertices"] > 200 and r["p90_plane_dist"] < r["bound"]
                and abs(r["vertices"] - r["cpu_vertices"]) <= 0.02 * r["cpu_vertices"]):
            fail(f"streaming_mesh_room {mode}: {r}")


def phase_checkpoint() -> None:
    """SMALL written by the port's ``save_checkpoint`` and read back by
    ``from_pretrained(dir)``: the same tensors, the same outputs, bit for bit."""
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.models.weights import save_checkpoint

    ckpt = WORK / "ckpt"
    model = DepthAnything3.from_pretrained("small", seed=0, device="cuda")
    save_checkpoint(ckpt, model.net.state_dict(), model.cfg)
    loaded = DepthAnything3.from_pretrained(str(ckpt), device="cuda")
    sd, sd2 = model.net.state_dict(), loaded.net.state_dict()
    same_tensors = set(sd) == set(sd2) and all(torch.equal(sd[k], sd2[k]) for k in sd)
    frames = make_frames(2)
    a, b = model.inference(image=frames), loaded.inference(image=frames)
    same_outputs = all(np.array_equal(getattr(a, f), getattr(b, f))
                       for f in ("depth", "conf", "extrinsics", "intrinsics"))
    emit("checkpoint", preset="small", tensors=len(sd),
         file_bytes=(ckpt / "model.safetensors").stat().st_size,
         config_equal=loaded.cfg == model.cfg, tensors_bit_equal=same_tensors,
         outputs_bit_equal=same_outputs, outputs_finite=bool(np.isfinite(b.depth).all()))
    if not (loaded.cfg == model.cfg and same_tensors and same_outputs
            and np.isfinite(b.depth).all()):
        fail("checkpoint: the loaded model is not the one that was saved")


def phase_pipeline(path_launches: dict, slam_runs: dict) -> None:
    """``run_streaming_slam`` over the 31 frames (SMALL, chunk 15, overlap 1,
    bf16, ICP): whole and in one-window segments spilled to the host.  The two
    agree, and their trajectory is ``main_slam``'s device-resident one of the
    same weights and frames (phase_main_slam_irls's ``icp`` run), to
    PIPELINE_TOL.  The host's waits for the device are counted beside
    ``main_slam``'s."""
    from da3slam_tpu_torch.core.transforms import se3_inverse, se3_to_4x4
    from da3slam_tpu_torch.inout.images import decode_image, load_image_paths
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.slam.pipeline import make_windows, run_streaming_slam

    frames = np.stack([decode_image(p) for p in load_image_paths(str(frames_dir()))])
    model = DepthAnything3.from_pretrained("small", seed=0, device="cuda")
    _, anchors = make_windows(N_FRAMES, 15, 1)
    outs, stats = {}, {}
    for tag, kw in (("whole", {}),
                    ("segmented", {"segment_windows": 1, "segment_spill": "host"})):
        box = {}

        def run(kw=kw, box=box):
            box["out"] = run_streaming_slam(model.net, frames, model.cfg, chunk_size=15,
                                            overlap=1, process_hw=(504, 504), **kw)

        torch.cuda.synchronize()
        with counted(path_launches, f"pipeline_{tag}"):
            t0 = time.perf_counter()
            syncs = _count_syncs(run)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        outs[tag] = [np.asarray(t.cpu()) if isinstance(t, torch.Tensor) else t
                     for t in box["out"]]
        launches = path_launches[f"pipeline_{tag}"]
        stats[tag] = {"wall_s": wall, "frames_per_s": N_FRAMES / wall, "host_syncs": syncs,
                      "bound_launches": launches["flash_attn_bound_fwd"],
                      "outputs_are": type(box["out"].depth).__name__}
        if launches != expected_launches(flash_attn_bound_fwd=EXPECTED_LAUNCHES):
            fail(f"pipeline {tag}: launches {launches}")
        if not all(np.isfinite(a).all() for a in outs[tag]):
            fail(f"pipeline {tag}: outputs not finite")
    seg_diff = max(float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())
                   for a, b in zip(outs["whole"], outs["segmented"]))
    ext = outs["whole"][2]  # [C, N, 3, 4] w2c; drop each later window's overlap frames
    w2c = np.concatenate([ext[k][(anchors[k] + 1 if k else 0):] for k in range(len(anchors))])
    c2w = se3_to_4x4(se3_inverse(torch.from_numpy(w2c))).numpy()
    slam = np.loadtxt(WORK / "out_icp" / "camera_poses.txt", ndmin=2).reshape(-1, 4, 4)
    slam_diff = float(np.abs(c2w - slam).max()) if c2w.shape == slam.shape else None
    emit("pipeline", frames=N_FRAMES, preset="small", chunk_size=15, overlap=1, dtype="bfloat16",
         runs=stats, poses_shape=list(c2w.shape), poses_finite=bool(np.isfinite(c2w).all()),
         whole_vs_segmented_max_abs_diff=seg_diff, vs_main_slam_max_abs_diff=slam_diff,
         tol=PIPELINE_TOL,
         # beside it: main_slam's device-resident ICP run with its model
         # resident too (it decodes the 31 PNGs, the pipeline gets an array)
         main_slam_icp_loop_host_syncs=slam_runs["icp"]["split"]["host_syncs"]["loop"],
         main_slam_icp_run_s=slam_runs["icp"]["split"]["run_s"],
         main_slam_icp_run_frames_per_s=slam_runs["icp"]["split"]["run_frames_per_s"])
    if c2w.shape != (N_FRAMES, 4, 4) or not np.isfinite(c2w).all():
        fail(f"pipeline: poses {c2w.shape}, finite={np.isfinite(c2w).all()}")
    if not seg_diff <= PIPELINE_TOL:
        fail(f"pipeline: whole and segmented runs differ by {seg_diff}")
    if slam_diff is None or not slam_diff <= PIPELINE_TOL:
        fail(f"pipeline: trajectory differs from main_slam's by {slam_diff}")
    # where one warm SMALL chunk's device time goes (launch counts already read)
    _profile("small_chunk_profile", lambda: model.inference(image=frames[:15]),
             preset="small", frames=15, dtype="bfloat16")


def c3vd_frames_dir() -> Path:
    """31 generated frames at C3VD's 1080×1350 (JPEG): a textured field
    drifting sideways under an exposure that swings from dark to bright,
    what the brightness pass normalises."""
    from PIL import Image

    image_dir = WORK / "c3vd_frames"
    if not image_dir.exists():
        image_dir.mkdir(parents=True)
        H, W = C3VD_HW
        rng = np.random.default_rng(2)
        shift = 4
        yy, xx = np.mgrid[0:H, 0:W + shift * N_FRAMES].astype(np.float32) / H
        phases = rng.uniform(0, 2 * np.pi, size=(3, 2))
        base = np.stack([0.5 + 0.25 * np.sin(2 * np.pi * (3 * xx + 2 * yy) + phases[c, 0])
                         + 0.2 * np.sin(2 * np.pi * (7 * yy - 5 * xx) + phases[c, 1])
                         for c in range(3)], -1)
        for i in range(N_FRAMES):
            gain = 0.35 + 1.1 * i / (N_FRAMES - 1)
            f = base[:, shift * i: shift * i + W] * gain * 255.0
            f = f + rng.integers(0, 8, size=f.shape, dtype=np.uint8)
            Image.fromarray(np.clip(f, 0, 255).astype(np.uint8)).save(
                image_dir / f"{i:06d}.jpg", quality=95)
    return image_dir


def _lab_bin_flips(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pixels whose CLAHE bin (int32 truncation of L) differs."""
    return a[..., 0].astype(np.int32) != b[..., 0].astype(np.int32)


def phase_preprocess(path_launches: dict) -> Path:
    """``cli/preprocess crop --dataset c3vd2`` then ``brightness`` over the 31
    C3VD-sized frames on the card; ``preprocess_batch`` over 16 of them to
    504² (the counterpart of ``bench.py:452 bench_preprocess_fps``), CUDA
    events: frames/s; card against CPU on two cropped frames: the uint8
    outputs within 1 LSB wherever no CLAHE bin flips, the flips counted.
    Returns the normalised frames' directory."""
    from da3slam_tpu_torch.cli import preprocess as cli
    from da3slam_tpu_torch.inout.images import decode_image, load_image_paths
    from da3slam_tpu_torch.preprocess import device as pdev
    from da3slam_tpu_torch.preprocess.host import CROP_PRESETS

    src = c3vd_frames_dir()
    crop_dir, norm_dir = WORK / "c3vd_cropped", WORK / "c3vd_norm"
    torch.cuda.synchronize()
    with counted(path_launches, "preprocess"):
        t0 = time.perf_counter()
        cli.main(["crop", "--input", str(src), "--output", str(crop_dir), "--dataset", "c3vd2"])
        t1 = time.perf_counter()
        cli.main(["brightness", "--input", str(crop_dir), "--output", str(norm_dir)])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    launches = path_launches["preprocess"]
    cropped = load_image_paths(str(crop_dir))
    normed = load_image_paths(str(norm_dir))
    crop_hw = decode_image(normed[0]).shape

    frames = torch.from_numpy(np.stack([decode_image(p) for p in load_image_paths(str(src))[:16]]))
    batch = frames.to("cuda")
    preset = CROP_PRESETS["c3vd2"]

    def run():
        return pdev.preprocess_batch(batch, preset["ratio"], preset["x_offset"],
                                     out_hw=(504, 504))

    torch.cuda.reset_peak_memory_stats()
    out = run()
    ms = cuda_ms(run, reps=5)
    state = gpu_state()
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(out).all().item())

    two = np.stack([decode_image(p) for p in cropped[:2]])
    card = pdev.adjust_brightness(torch.from_numpy(two).to("cuda")).cpu().numpy()
    host = pdev.adjust_brightness(torch.from_numpy(two)).numpy()
    flips = _lab_bin_flips(pdev.rgb_to_lab(torch.from_numpy(two).to("cuda")).cpu().numpy(),
                           pdev.rgb_to_lab(torch.from_numpy(two)).numpy())
    diff = np.abs(card.astype(np.int32) - host.astype(np.int32))
    flip_bound = max(2.0, PREPROCESS_FLIP_SHARE * flips.size)
    clean = ~flips.any(axis=(1, 2))
    emit("preprocess", frames=N_FRAMES, frame_hw=list(C3VD_HW), dataset="c3vd2",
         cropped_hw=list(crop_hw[:2]), crop_s=t1 - t0, brightness_s=t2 - t1,
         cli_frames_per_s=N_FRAMES / (t2 - t0),
         cli_includes="JPEG decode and encode, one upload and fetch a frame (crop) or batch",
         batch=16, out_hw=[504, 504], preprocess_batch_ms=ms,
         preprocess_batch_frames_per_s=16 / ms * 1e3, gpu_state=state,
         max_memory_allocated_bytes=peak, output_finite=finite,
         card_vs_cpu_frames=2, bin_flips=int(flips.sum()), bin_flip_bound=flip_bound,
         frames_without_flips=int(clean.sum()), max_abs_lsb=int(diff.max()),
         max_abs_lsb_without_flips=int(diff[clean].max()) if clean.any() else None,
         pixels_over_1_lsb=int((diff > 1).sum()), kernel_launches=launches)
    if len(cropped) != N_FRAMES or len(normed) != N_FRAMES:
        fail(f"preprocess: {len(cropped)} cropped, {len(normed)} normalised of {N_FRAMES}")
    if not finite or tuple(out.shape) != (16, 504, 504, 3):
        fail(f"preprocess: preprocess_batch gave {tuple(out.shape)}, finite={finite}")
    if flips.sum() > flip_bound or (clean.any() and diff[clean].max() > 1):
        fail(f"preprocess: card against CPU, {int(flips.sum())} bin flips (bound {flip_bound}), "
             f"{int(diff[clean].max()) if clean.any() else None} LSB without flips")
    if launches != expected_launches():
        fail(f"preprocess: launches {launches}")
    return norm_dir


def tsdf_scene():
    """``bench.py:_tsdf_scene``: ground-truth depth of a 360° orbit inside
    the closed box at 504², confidence 1."""
    from da3slam_tpu_torch.utils.synthetic import (
        BOX_PLANES,
        default_intrinsics,
        make_orbit_trajectory,
        render_depth,
    )

    hw = (TSDF_HW, TSDF_HW)
    K = default_intrinsics(hw)
    poses = make_orbit_trajectory(TSDF_FRAMES)
    depth = np.stack([render_depth(E, K, hw, planes=BOX_PLANES) for E in poses])
    return (depth.astype(np.float32), np.ones(depth.shape, np.float32),
            np.repeat(K[None], TSDF_FRAMES, 0).astype(np.float32), poses.astype(np.float32))


def _grid_diff(a, b) -> dict:
    """Card grid against CPU grid: max |diff| and the voxels beyond tolerance."""
    out = {"share_over_tol": 0.0}
    bad = torch.zeros(a.sdf.shape, dtype=torch.bool)
    for f, tol in (("sdf", TSDF_TOL), ("weight", TSDF_TOL), ("color", 1e-3)):
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            continue
        d = (x.cpu() - y).abs()
        out[f"{f}_max_abs_diff"] = d.max().item()
        bad |= (d > tol) if d.ndim == 3 else (d > tol).any(-1)
    out["voxels_over_tol"] = int(bad.sum())
    out["share_over_tol"] = bad.float().mean().item()
    return out


def phase_tsdf(path_launches: dict) -> None:
    """The TSDF benchmark scene fused dense, sparse and sparse with carve on
    the card (a warm run, then the median of 3 by the host clock, synced):
    frames/s, peak active blocks against the budget, host waits, peak memory;
    card against CPU on every 14th frame (dense and sparse); the card's sparse
    grid against its dense ``band_only`` grid bit for bit; the sparse grid's
    mesh against the box planes (median distance under one voxel), marching
    tetrahedra's host time apart."""
    import statistics

    from da3slam_tpu_torch.inout.mesh import tsdf_to_mesh
    from da3slam_tpu_torch.ops import tsdf
    from da3slam_tpu_torch.utils.synthetic import BOX_PLANES

    scene = tsdf_scene()
    depth, conf, K, E = (torch.from_numpy(a).to("cuda") for a in scene)
    lo, hi = tsdf.estimate_bounds(depth[:16], K[:16], E[:16], resolution=TSDF_RES)
    grid0 = tsdf.grid_from_bounds(lo, hi, TSDF_RES, device="cuda")
    voxels = grid0.sdf.numel()
    modes, grids = {}, {}
    with counted(path_launches, "tsdf"):
        for mode in ("dense", "sparse", "carve"):
            budget = peak_blocks = None
            if mode != "dense":
                carve = mode == "carve"
                _, counts = tsdf.integrate_frames_sparse(grid0, depth, conf, K, E,
                                                         batch=TSDF_BATCH, carve=carve)
                peak_blocks = int(counts.max())
                budget = -(-(peak_blocks + 1) // 128) * 128

                def run(carve=carve, budget=budget):
                    return tsdf.integrate_frames_sparse(grid0, depth, conf, K, E,
                                                        active_blocks=budget, batch=TSDF_BATCH,
                                                        carve=carve)
            else:
                def run():
                    return tsdf.integrate_frames(grid0, depth, conf, K, E), None
            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            box, where = {}, {}
            syncs = _count_syncs(lambda: box.setdefault("out", run()), where)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                g, counts = run()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            grids[mode] = g
            wall = statistics.median(times)
            modes[mode] = {"wall_s": wall, "frames_per_s": TSDF_FRAMES / wall, "walls_s": times,
                           "host_syncs": syncs, "host_syncs_at": where,
                           "gpu_state": gpu_state(),
                           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                           "peak_active_blocks": peak_blocks, "block_budget": budget,
                           "budget_counts_max": None if counts is None else int(counts.max())}
            if counts is not None and counts.max() > budget:
                fail(f"tsdf {mode}: {int(counts.max())} active blocks over the budget {budget}")
    launches = path_launches["tsdf"]

    # card against CPU, and the sparse grid against dense band_only, on every
    # 14th frame (8 frames: one sparse step)
    sub = [a[::14] for a in scene]
    cpu0 = tsdf.grid_from_bounds(lo, hi, TSDF_RES, device="cpu")
    vs_cpu = {}
    for name, fn in (("dense", lambda g, *a: tsdf.integrate_frames(g, *a)),
                     ("sparse", lambda g, *a: tsdf.integrate_frames_sparse(g, *a)[0])):
        card = fn(grid0, *(torch.from_numpy(a).to("cuda") for a in sub))
        host = fn(cpu0, *(torch.from_numpy(a) for a in sub))
        vs_cpu[name] = _grid_diff(card, host)
    band = grid0
    pts = tsdf._voxel_centers_world(grid0)
    for i in range(len(sub[0])):
        band = tsdf.integrate(band, *(torch.from_numpy(a[i]).to("cuda") for a in sub),
                              pts_world=pts, band_only=True)
    sparse_sub = tsdf.integrate_frames_sparse(grid0, *(torch.from_numpy(a).to("cuda")
                                                       for a in sub))[0]
    band_equal = all(torch.equal(getattr(band, f), getattr(sparse_sub, f))
                     for f in ("sdf", "weight"))
    band_diff = max((getattr(band, f) - getattr(sparse_sub, f)).abs().max().item()
                    for f in ("sdf", "weight"))

    t0 = time.perf_counter()
    verts, faces = tsdf_to_mesh(grids["sparse"])
    mesh_s = time.perf_counter() - t0
    voxel = float(grid0.voxel)
    dists = np.min(np.stack([np.abs(verts @ np.asarray(n) - c) for n, c in BOX_PLANES]), axis=0) \
        if len(verts) else np.full(1, np.inf)
    emit("tsdf", frames=TSDF_FRAMES, hw=[TSDF_HW, TSDF_HW], resolution=TSDF_RES,
         grid=list(grid0.sdf.shape), voxels=voxels, voxel=voxel, batch=TSDF_BATCH, modes=modes,
         card_vs_cpu_frames=len(sub[0]), card_vs_cpu=vs_cpu, tol=TSDF_TOL,
         edge_share_bound=TSDF_EDGE_SHARE, sparse_vs_band_only_bit_equal=band_equal,
         sparse_vs_band_only_max_abs_diff=band_diff, mesh_host_s=mesh_s,
         mesh_vertices=int(len(verts)), mesh_faces=int(len(faces)),
         mesh_median_plane_dist=float(np.median(dists)),
         mesh_p95_plane_dist=float(np.quantile(dists, 0.95)), kernel_launches=launches)
    for name, d in vs_cpu.items():
        if not d["share_over_tol"] <= TSDF_EDGE_SHARE:
            fail(f"tsdf: card against CPU ({name}): {d}")
    if not band_equal:
        fail(f"tsdf: the sparse grid is not the dense band_only grid (max diff {band_diff})")
    if len(verts) < 1000 or not np.median(dists) < voxel:
        fail(f"tsdf: mesh of {len(verts)} vertices, median plane distance {np.median(dists)} "
             f"against a voxel of {voxel}")
    if launches != expected_launches():
        fail(f"tsdf: launches {launches}")


def phase_main_mesh(path_launches: dict, image_dir: Path) -> None:
    """``cli/main_mesh`` at SMALL, full width (chunk 8, ``--process_res 504``)
    over phase 22's 31 normalised frames, once dense ``--color`` and once
    ``--sparse``: a non-empty finite mesh, 12 bound-forward launches a chunk,
    frames/s (building SMALL included)."""
    from da3slam_tpu_torch.cli import main_mesh
    from da3slam_tpu_torch.inout.mesh import read_mesh_ply

    runs = {}
    for tag, flags in (("dense_color", ["--color"]), ("sparse", ["--sparse"])):
        out = WORK / f"mesh_{tag}.ply"
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with counted(path_launches, f"main_mesh_{tag}"):
            t0 = time.perf_counter()
            main_mesh.main(["--image_dir", str(image_dir), "--chunk_size", str(MESH_CHUNK),
                            "--process_res", "504", "--output", str(out)] + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = path_launches[f"main_mesh_{tag}"]
        expected = expected_launches(flash_attn_bound_fwd=12 * MESH_CHUNKS)
        verts, faces, cols = read_mesh_ply(out, with_colors=True)
        runs[tag] = {"wall_s": wall, "frames_per_s": N_FRAMES / wall,
                     "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
                     "vertices": int(len(verts)), "faces": int(len(faces)),
                     "finite": bool(np.isfinite(verts).all()), "colors": cols is not None,
                     "kernel_launches": launches, "expected_launches": expected}
        if len(verts) == 0 or not np.isfinite(verts).all() or (cols is not None) != (tag != "sparse"):
            fail(f"main_mesh {tag}: {len(verts)} vertices, finite={np.isfinite(verts).all()}, "
                 f"colors={cols is not None}")
        if launches != expected:
            fail(f"main_mesh {tag}: launches {launches} != {expected}")
    emit("main_mesh", frames=N_FRAMES, preset="small", chunk_size=MESH_CHUNK, chunks=MESH_CHUNKS,
         process_res=504, resolution=192, cross_seq_len=MESH_CHUNK * 1301,
         wall_includes="building SMALL on the CPU, its upload, JPEG decode, the mesh and PLY",
         runs=runs)


def raster_scene(G: int, hw: int, seed: int = 0) -> list[torch.Tensor]:
    """G seeded splats filling the view of an identity camera at hw² (depths
    2-6, footprints of a few pixels), fx = hw: means, scales, quats, colors,
    opacity (below 0.995), K, E on the CPU."""
    gen = torch.Generator().manual_seed(seed)

    def u(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(*shape, generator=gen)

    z = u(2.0, 6.0, G)
    means = torch.stack([u(-0.5, 0.5, G) * z, u(-0.5, 0.5, G) * z, z], -1)
    quats = torch.randn(G, 4, generator=gen)
    K = torch.tensor([[float(hw), 0, hw / 2], [0, float(hw), hw / 2], [0, 0, 1]])
    return [means, u(0.002, 0.012, G, 3), quats / quats.norm(dim=-1, keepdim=True),
            u(0.05, 0.95, G, 3), u(0.2, 0.9, G), K, torch.eye(4)[:3]]


def toy_train_scene() -> tuple[list[torch.Tensor], tuple[int, int]]:
    """``tests/test_rasterize.py``'s toy training scene: 25 splats, targets
    rendered from two views with other colors."""
    from da3slam_tpu_torch.ops.rasterize import rasterize

    hw = (64, 96)
    rng = np.random.default_rng(6)
    G = 25
    means = np.stack([rng.uniform(-0.6, 0.6, G), rng.uniform(-0.36, 0.36, G),
                      rng.uniform(2.0, 4.0, G)], -1)
    scales = rng.uniform(0.02, 0.08, (G, 3))
    quats = rng.normal(size=(G, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    colors = rng.uniform(0.1, 0.9, (G, 3))
    opacity = rng.uniform(0.3, 0.9, G)
    K = np.array([[80.0, 0, hw[1] / 2], [0, 80.0, hw[0] / 2], [0, 0, 1.0]])
    E = np.eye(4)[:3]
    E2 = np.array([[1, 0, 0, 0.05], [0, 1, 0, 0.0], [0, 0, 1, 0.02]])
    gt = np.random.default_rng(7).uniform(0.1, 0.9, colors.shape)
    t = [torch.as_tensor(a, dtype=torch.float32, device="cuda")
         for a in (means, scales, quats, colors, opacity, K, E, E2, gt)]
    with torch.no_grad():
        images = torch.stack([rasterize(*t[:3], t[8], t[4], t[5], e, hw)[0] for e in (t[6], t[7])])
    return [*t[:5], images, torch.stack([t[5], t[5]]), torch.stack([t[6], t[7]])], hw


def phase_rasterize(path_launches: dict) -> None:
    """The tile rasterizer alone on the card: 2^20 seeded splats at 504², K =
    256, fan 5 (what ``main_3dgs --train_iters`` and ``render`` run), held
    against the same render and gradients on the CPU; host waits of a render;
    render, binning (sort included) and forward + backward times (CUDA
    events, median) and peak memory; the tiled render against
    ``rasterize_dense`` on a 40-splat scene; the toy training scene's loss."""
    from da3slam_tpu_torch.ops.rasterize import bin_splats, project_gaussians, rasterize, \
        rasterize_dense, sort_keys
    from da3slam_tpu_torch.ops.splats import train_splats

    hw = (RASTER_HW, RASTER_HW)
    scene = raster_scene(RASTER_SPLATS, RASTER_HW)
    target = torch.rand(*hw, 3, generator=torch.Generator().manual_seed(1))

    def fwd_bwd(device):
        splats = [x.to(device).requires_grad_(True) for x in scene[:5]]
        rgb, alpha, aux = rasterize(*splats, *(x.to(device) for x in scene[5:]), hw)
        torch.mean((rgb - target.to(device)) ** 2).backward()
        return rgb.detach(), alpha.detach(), aux, [p.grad for p in splats]

    with counted(path_launches, "rasterize"):
        card = fwd_bwd("cuda")
        torch.cuda.synchronize()
    launches = path_launches["rasterize"]
    t0 = time.perf_counter()
    host = fwd_bwd("cpu")
    cpu_s = time.perf_counter() - t0
    rgb_err = max((card[0].cpu() - host[0]).abs().max().item(),
                  (card[1].cpu() - host[1]).abs().max().item())
    grad_err = {name: ((g.cpu() - h).abs().max() / h.abs().max()).item()
                for name, g, h in zip(("means", "scales", "quats", "colors", "opacity"),
                                      card[3], host[3])}
    tables_equal = torch.equal(card[2]["overflow"].cpu(), host[2]["overflow"]) and \
        int(card[2]["n_binned"]) == int(host[2]["n_binned"])

    dev = [x.to("cuda") for x in scene]
    where: dict = {}
    first_where: dict = {}
    with torch.no_grad():
        # the first render of a run is counted apart: the waits counted
        # are those of every render after it
        first_syncs = _count_syncs(lambda: rasterize(*dev, hw), first_where)
        syncs = _count_syncs(lambda: rasterize(*dev, hw), where)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        render_ms = cuda_ms(lambda: rasterize(*dev, hw), 5)
        render_peak = torch.cuda.max_memory_allocated()
        proj = project_gaussians(*dev[:3], dev[5], dev[6], hw)
        bin_ms = cuda_ms(lambda: bin_splats(proj, hw), 5)
        # the sort alone, on keys of the binning's length and kind: tile ids
        # over the 32² tiles and the dropped id, this scene's depths
        n_tiles = ((RASTER_HW + 15) // 16) ** 2
        gen = torch.Generator(device="cuda").manual_seed(2)
        keys = sort_keys(torch.randint(0, n_tiles + 1, (RASTER_SPLATS * 25,), device="cuda",
                                       generator=gen), proj.depth.repeat_interleave(25))
        sort_ms = cuda_ms(lambda: torch.sort(keys, stable=True), 5)
        del keys
    splats = [x.requires_grad_(True) for x in (t.clone() for t in dev[:5])]
    tgt = target.to("cuda")

    def step():
        rgb, _, _ = rasterize(*splats, dev[5], dev[6], hw)
        torch.mean((rgb - tgt) ** 2).backward()

    torch.cuda.reset_peak_memory_stats()
    fwd_bwd_ms = cuda_ms(step, 5)
    fwd_bwd_peak = torch.cuda.max_memory_allocated()
    state = gpu_state()

    small = [t.to("cuda") for t in raster_scene(40, 96, seed=3)]
    small[1] = small[1] * 6.0  # footprints over several tiles
    with torch.no_grad():
        rgb_t, a_t, aux_t = rasterize(*small, (80, 96), max_per_tile=64, fan=9)
        rgb_d, a_d = rasterize_dense(*small, (80, 96))
    dense_err = max((rgb_t - rgb_d).abs().max().item(), (a_t - a_d).abs().max().item())

    args, toy_hw = toy_train_scene()
    toy = train_splats(*args, toy_hw, iters=30, max_per_tile=64, fan=9)
    toy_losses = toy.losses.cpu().tolist()

    emit("rasterize", splats=RASTER_SPLATS, hw=list(hw), max_per_tile=256, fan=5,
         binned=int(card[2]["n_binned"]), overflow=int(card[2]["overflow"].sum()),
         card_vs_cpu_rgb_max_abs=rgb_err, rgb_tol=RASTER_RGB_TOL,
         card_vs_cpu_grad_rel=grad_err, grad_rel_tol=RASTER_GRAD_REL_TOL,
         card_vs_cpu_binning_equal=tables_equal, cpu_fwd_bwd_s=cpu_s,
         host_syncs_a_render=syncs, host_syncs_at=where, host_syncs_first_render=first_syncs,
         host_syncs_first_render_at=first_where,
         render_ms=render_ms, bin_ms=bin_ms, bin_share=bin_ms / render_ms, sort_ms=sort_ms,
         sort_share=sort_ms / render_ms,
         render_peak_bytes=render_peak, fwd_bwd_ms=fwd_bwd_ms, fwd_bwd_peak_bytes=fwd_bwd_peak,
         gpu_state=state, tiled_vs_dense_max_abs=dense_err, dense_binned=int(aux_t["n_binned"]),
         toy_losses_first_last=[toy_losses[0], toy_losses[-1]], kernel_launches=launches)
    if rgb_err > RASTER_RGB_TOL or max(grad_err.values()) > RASTER_GRAD_REL_TOL:
        fail(f"rasterize: card against CPU, rgb {rgb_err}, gradients {grad_err}")
    if not tables_equal:
        fail("rasterize: the card's binning counts differ from the CPU's")
    if syncs:
        fail(f"rasterize: {syncs} host waits in a render at {where}")
    if dense_err > 2e-5 or int(aux_t["overflow"].sum()):
        fail(f"rasterize: tiled against dense {dense_err}")
    if not toy_losses[-1] < 0.6 * toy_losses[0]:
        fail(f"rasterize: the toy scene's loss went {toy_losses[0]} -> {toy_losses[-1]}")
    if launches != expected_launches():
        fail(f"rasterize: launches {launches}")


@contextlib.contextmanager
def timed_calls(module, names: tuple, seconds: dict):
    """Wrap ``module.<name>`` so that each call's wall time (the device
    synced after it) adds to ``seconds[name]``; restored on exit."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    for n in names:
        setattr(module, n, wrap(n, saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


def phase_main_3dgs(path_launches: dict, image_dir: Path) -> Path:
    """``cli/main_3dgs`` at SMALL, full width (chunk 8, ``--process_res 504``)
    over phase 22's 31 frames: once plain with ``--glb``, once with
    ``--refine_iters``, ``--train_iters`` and ``--densify_every``: finite PLY
    and GLB, 12 bound-forward launches a chunk, the training loss falling;
    frames/s, the seconds of each pass and a train step, peak memory.
    Returns the trained PLY."""
    from da3slam_tpu_torch.cli import main_3dgs
    from da3slam_tpu_torch.inout.export3d import read_3dgs_ply
    from da3slam_tpu_torch.ops import splats

    runs = {}
    opt_flags = ["--refine_iters", str(GS_REFINE_ITERS), "--train_iters", str(GS_TRAIN_ITERS),
                 "--densify_every", str(GS_DENSIFY_EVERY)]
    for tag, flags in (("plain", ["--glb", str(WORK / "scene.glb")]), ("train", opt_flags)):
        out = WORK / f"scene_3dgs_{tag}.ply"
        seconds: dict = {}
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with counted(path_launches, f"main_3dgs_{tag}"), \
                timed_calls(splats, ("refine_splats", "train_splats"), seconds):
            t0 = time.perf_counter()
            res = main_3dgs.main(["--image_dir", str(image_dir), "--chunk_size", str(MESH_CHUNK),
                                  "--process_res", "504", "--output", str(out)] + flags)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = path_launches[f"main_3dgs_{tag}"]
        expected = expected_launches(flash_attn_bound_fwd=12 * MESH_CHUNKS)
        gs = read_3dgs_ply(out)
        finite = all(np.isfinite(v).all() for v in gs.values())
        run = {"wall_s": wall, "frames_per_s": N_FRAMES / wall, "splats": res["n"],
               "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
               "pass_s": seconds, "finite": finite, "kernel_launches": launches,
               "expected_launches": expected}
        if tag == "plain":
            glb = (WORK / "scene.glb").read_bytes()
            run["glb_bytes"] = len(glb)
            n_json = int.from_bytes(glb[12:16], "little")
            glb_pts = np.frombuffer(glb[28 + n_json:], np.float32,
                                    count=3 * json.loads(glb[20:20 + n_json])["accessors"][0]["count"])
            run["glb_points"] = len(glb_pts) // 3
            if glb[:4] != b"glTF" or not len(glb_pts) or not np.isfinite(glb_pts).all():
                fail(f"main_3dgs: the GLB holds {len(glb_pts) // 3} points, finite "
                     f"{np.isfinite(glb_pts).all()}")
        else:
            losses = res["train"].cpu().tolist()
            run.update(train_losses=losses, refine_losses=res["refine"].cpu().tolist(),
                       train_step_s=seconds["train_splats"] / GS_TRAIN_ITERS,
                       refine_step_s=seconds["refine_splats"] / GS_REFINE_ITERS)
            if not losses[-1] < losses[0]:
                fail(f"main_3dgs: the training loss went {losses}")
        runs[tag] = run
        if not finite or res["n"] < 100_000:
            fail(f"main_3dgs {tag}: {res['n']} splats, finite={finite}")
        if launches != expected:
            fail(f"main_3dgs {tag}: launches {launches} != {expected}")
    emit("main_3dgs", frames=N_FRAMES, preset="small", chunk_size=MESH_CHUNK, chunks=MESH_CHUNKS,
         process_res=504, stride=2, refine_iters=GS_REFINE_ITERS, train_iters=GS_TRAIN_ITERS,
         densify_every=GS_DENSIFY_EVERY, cross_seq_len=MESH_CHUNK * 1301,
         wall_includes="building SMALL on the CPU, its upload, JPEG decode, the exports",
         gpu_state=gpu_state(), runs=runs)
    return WORK / "scene_3dgs_train.ply"


def phase_render(path_launches: dict, splats_ply: Path) -> None:
    """``cli/render`` over phase 26's trained PLY along three written c2w
    poses with ``--interp``: the PNG count, non-constant frames, frames/s;
    then the first two poses rendered on the CPU, held against the card's
    frames of those poses within 1 LSB."""
    from PIL import Image

    from da3slam_tpu_torch.cli import render
    from da3slam_tpu_torch.core.transforms import so3_exp

    poses = np.stack([np.eye(4)] * 3)
    poses[1, :3, 3] = [0.05, 0.0, 0.02]
    poses[2, :3, :3] = so3_exp(torch.tensor([0.0, 0.08, 0.02])).numpy()
    pose_file = WORK / "render_poses.txt"
    with open(pose_file, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.8f}" for v in T.reshape(-1)) + "\n")
    pair_file = WORK / "render_pair.txt"
    pair_file.write_text("".join(pose_file.read_text().splitlines(True)[:2]))
    out, host_out = WORK / "render", WORK / "render_cpu"
    common = ["--splats", str(splats_ply), "--height", "504", "--width", "504"]
    with counted(path_launches, "render"):
        t0 = time.perf_counter()
        n = render.main(common + ["--poses", str(pose_file), "--output_dir", str(out),
                                  "--interp", str(RENDER_INTERP)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches["render"]
    t0 = time.perf_counter()
    render.main(common + ["--poses", str(pair_file), "--output_dir", str(host_out),
                          "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    frames = [np.asarray(Image.open(p)) for p in sorted(out.glob("*.png"))]
    stds = [float(f.std()) for f in frames]
    vs_cpu = []
    for card_i, host_i in ((0, 0), (RENDER_INTERP + 1, 1)):
        a = frames[card_i].astype(int)
        b = np.asarray(Image.open(host_out / f"{host_i:06d}.png")).astype(int)
        vs_cpu.append({"max_lsb": int(np.abs(a - b).max()),
                       "share_within_1_lsb": float((np.abs(a - b) <= 1).mean())})
    emit("render", frames=n, pngs=len(frames), hw=[504, 504], interp=RENDER_INTERP,
         wall_s=wall, frames_per_s=n / wall, frame_stds=stds, cpu_two_frames_s=cpu_s,
         card_vs_cpu=vs_cpu, lsb_share_bound=RENDER_LSB_SHARE, kernel_launches=launches)
    if n != len(frames) or n != 3 + 2 * RENDER_INTERP:
        fail(f"render: {n} frames, {len(frames)} PNGs")
    if min(stds) <= 0.0:
        fail(f"render: a constant frame (stds {stds})")
    if any(d["share_within_1_lsb"] < RENDER_LSB_SHARE for d in vs_cpu):
        fail(f"render: card against CPU {vs_cpu}")
    if launches != expected_launches():
        fail(f"render: launches {launches}")


@contextlib.contextmanager
def patched(cls, name: str, make):
    """Replace ``cls.<name>`` by ``make(original)`` (the original as the
    attribute was read from the class); restored on exit."""
    saved = cls.__dict__[name]
    setattr(cls, name, make(getattr(cls, name)))
    try:
        yield
    finally:
        setattr(cls, name, saved)


def schema_diff(sd: dict, schema: dict) -> dict:
    """A state dict's names and shapes against a published schema manifest
    (``tests/test_torch_model.py``'s check): what it has beyond the schema
    must be the schema's ``expected_missing``, what the schema has beyond it
    the DINOv2 mask tokens, and every shared name must have its shape."""
    keys = schema["keys"]
    extra = sorted(set(sd) - set(keys))
    lacking = sorted(set(keys) - set(sd))
    shapes = [k for k in set(sd) & set(keys) if list(sd[k].shape) != keys[k]]
    ok = (extra == sorted(schema["expected_missing"]) and not shapes
          and all(k.endswith("mask_token") for k in lacking))
    return {"ok": ok, "beyond_schema": extra, "schema_only": lacking, "shape_mismatch": shapes}


def phase_nested_checkpoint() -> tuple[Path, object]:
    """The nested tier at full width (giant + large, 1542 M parameters) made
    on the card from seeds 0 and 1, exported torch-style, held to the
    published nested manifest (``tests/fixtures/torch_schema_nested_giant.json``)
    and written as a nested checkpoint directory (``model.`` / ``metric_model.``
    prefixes, a ``config.json`` with a section each); then loaded back with
    ``from_pretrained``: a ``DepthAnything3Nested`` whose every tensor equals
    the built one's.  Bytes and seconds to write and to load.  Returns the
    directory and the built model."""
    import dataclasses
    import shutil

    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.models.da3 import DepthAnything3, init_params
    from da3slam_tpu_torch.models.nested import DepthAnything3Nested, export_torch_style_nested
    from da3slam_tpu_torch.models.weights import save_file

    t0 = time.perf_counter()
    subs = []
    for tier, seed in (("giant", 0), ("large", 1)):
        cfg = get_preset(tier)
        subs.append(DepthAnything3(cfg, init_params(cfg, seed, device="cuda")))
    nested = DepthAnything3Nested(*subs)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    sd = export_torch_style_nested(nested)
    schema = json.loads((ROOT / "tests" / "fixtures" / "torch_schema_nested_giant.json").read_text())
    diff = schema_diff(sd, schema)

    ckpt = WORK / "nested_ckpt" / NESTED_NAME
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    t0 = time.perf_counter()
    save_file(sd, ckpt / "model.safetensors")
    (ckpt / "config.json").write_text(json.dumps({
        "model": dataclasses.asdict(nested.anyview.cfg),
        "metric_model": dataclasses.asdict(nested.metric.cfg)}))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = DepthAnything3.from_pretrained(str(ckpt), device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    same = isinstance(loaded, DepthAnything3Nested)
    if same:
        for a, b in ((nested.anyview, loaded.anyview), (nested.metric, loaded.metric)):
            sa, sb = a.net.state_dict(), b.net.state_dict()
            same &= a.cfg == b.cfg and set(sa) == set(sb) and all(
                torch.equal(sa[k], sb[k]) for k in sa)
    del loaded
    torch.cuda.empty_cache()
    n_params = sum(p.numel() for sub in subs for p in sub.net.parameters())
    emit("nested_checkpoint", name=NESTED_NAME, tiers=["giant", "large"], seeds=[0, 1],
         parameters=n_params, tensors=len(sd), init_on_card_s=init_s,
         file_bytes=(ckpt / "model.safetensors").stat().st_size, write_s=write_s,
         load_s=load_s, load_includes="reading the file, making the missing tensors on the "
         "card, the import", schema=diff, loaded_bit_equal=same)
    if not diff["ok"]:
        fail(f"nested checkpoint against the published manifest: {diff}")
    if not same:
        fail("nested checkpoint: the loaded model is not the one that was written")
    return ckpt, nested


def phase_main_slam_nested(path_launches: dict, ckpt: Path, nested) -> Path:
    """``cli/main_slam`` with ``Weights.DA3`` at phase 28's nested checkpoint
    directory over the 31 frames (chunk 15, overlap 1: three chunks at 504²):
    192 bound-forward launches, finite poses, every chunk's metric scale;
    frames/s, the load and the run apart, peak memory.  Then the in-memory
    round trip: ``export_torch_style_nested`` → split → import gives outputs
    bit-equal to the built model on one chunk.  The checkpoint directory is
    deleted at the end.  Returns the trajectory's directory."""
    import shutil

    from da3slam_tpu_torch.cli import main_slam
    from da3slam_tpu_torch.models.da3 import DepthAnything3
    from da3slam_tpu_torch.models.nested import DepthAnything3Nested, export_torch_style_nested
    from da3slam_tpu_torch.models.torch_import import split_nested_state_dict

    out_dir = WORK / "out_nested"
    config = WORK / "nested.yaml"
    config.write_text(f"Weights: {{DA3: {ckpt}}}\n"
                      "Model: {chunk_size: 15, overlap_size: 1, keyframe_interval: 1, "
                      "sleep_between_chunk: 0}\n")
    seconds: dict = {}
    scales: list = []

    def timed_load(fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            model = fn(*a, **k)
            torch.cuda.synchronize()
            seconds["load"] = seconds.get("load", 0.0) + time.perf_counter() - t0
            return model
        return call

    def record_scale(fn):
        def call(self, *a, **k):
            pred = fn(self, *a, **k)
            scales.append(pred.metric_scale)
            return pred
        return call

    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with counted(path_launches, "main_slam_nested"), \
                patched(DepthAnything3, "from_pretrained", timed_load), \
                patched(DepthAnything3Nested, "inference", record_scale):
            t0 = time.perf_counter()
            solver = main_slam.main(["--image_dir", str(frames_dir()), "--config", str(config),
                                     "--output_dir", str(out_dir), "--headless"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        model_type = type(solver.model).__name__
        del solver
    finally:
        shutil.rmtree(ckpt.parent, ignore_errors=True)
    torch.cuda.empty_cache()
    launches = path_launches["main_slam_nested"]
    expected = expected_launches(flash_attn_bound_fwd=NESTED_EXPECTED_LAUNCHES)
    poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
    scales = [float(s) for s in scales]
    run_s = wall - seconds["load"]

    # the in-memory round trip on one chunk (15 frames at 504²)
    split = split_nested_state_dict(export_torch_style_nested(nested))
    again = DepthAnything3Nested.from_split_state_dicts(*split[:2], device="cuda")
    frames = make_frames(15, seed=1)
    a, b = nested.inference(image=frames), again.inference(image=frames)
    round_trip = all(np.array_equal(getattr(a, f), getattr(b, f))
                     for f in ("depth", "conf", "extrinsics", "intrinsics")) \
        and a.metric_scale == b.metric_scale
    del again
    torch.cuda.empty_cache()
    emit("main_slam_nested", model=model_type, tiers=["giant", "large"], frames=N_FRAMES,
         chunk_size=15, chunks=3, wall_s=wall, load_s=seconds["load"], run_s=run_s,
         frames_per_s=N_FRAMES / wall, run_frames_per_s=N_FRAMES / run_s,
         wall_includes="the checkpoint's load (file read, tensors made on the card, import), "
         "PNG decode, export", max_memory_allocated_bytes=peak, metric_scales=scales,
         poses_shape=list(poses.shape), poses_finite=bool(np.isfinite(poses).all()),
         round_trip_bit_equal=round_trip, round_trip_metric_scale=a.metric_scale,
         kernel_launches=launches, expected_launches=expected, gpu_state=gpu_state())
    if model_type != "DepthAnything3Nested":
        fail(f"main_slam_nested: the checkpoint loaded as {model_type}")
    if poses.shape != (N_FRAMES, 16) or not np.isfinite(poses).all():
        fail(f"main_slam_nested: camera_poses.txt {poses.shape}, finite {np.isfinite(poses).all()}")
    if len(scales) != 3 or not all(np.isfinite(s) and s > 0 for s in scales):
        fail(f"main_slam_nested: metric scales {scales}")
    if launches != expected:
        fail(f"main_slam_nested: launches {launches} != {expected}")
    if not round_trip:
        fail("main_slam_nested: export → split → import does not give the built model's outputs")
    return out_dir


def phase_nested_parity() -> tuple[Path, Path]:
    """The nested tier at giant and large widths, cut to 4 blocks each
    (``dpt_layers`` 0-3), its depth channel put at depths of order 1
    (``NESTED_DEPTH_BIAS``) and its LayerScale at 0.1, on 2 unrelated frames
    at 518²: f32 on the card (kernels,
    ``highest_precision``) against the same weights on the CPU (plain
    attention), depth, conf, extrinsics, intrinsics and the metric scale
    within MODEL_PARITY_TOL.  The CPU run also writes the parity golden (its
    prediction, and its ``export_dir`` beside it) and the weights go to a
    nested checkpoint directory; both are returned for the parity CLI."""
    import dataclasses

    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.models.da3 import DepthAnything3, init_params
    from da3slam_tpu_torch.models.nested import DepthAnything3Nested, export_torch_style_nested
    from da3slam_tpu_torch.models.weights import save_file

    cut = dict(depth=NESTED_PARITY_DEPTH, dpt_layers=tuple(range(NESTED_PARITY_DEPTH)),
               layerscale_init=NESTED_PARITY_LAYERSCALE)
    subs = [DepthAnything3(cfg, init_params(cfg, seed))
            for cfg, seed in ((get_preset("giant").with_overrides(**cut), 0),
                              (get_preset("large").with_overrides(**cut), 1))]
    with torch.no_grad():
        for sub in subs:
            last = sub.net.depth_head.scratch.output_conv2[2]
            last.weight[0] *= NESTED_DEPTH_WEIGHT_SCALE
            last.bias[0] = NESTED_DEPTH_BIAS
    cpu = DepthAnything3Nested(*subs)
    gpu = DepthAnything3Nested(*[DepthAnything3(s.cfg, copy.deepcopy(s.net).to("cuda"),
                                                dtype=torch.float32) for s in subs])
    frames = np.concatenate([make_frames(1, seed=s) for s in NESTED_PARITY_FRAME_SEEDS])
    export = WORK / "nested_parity_export"
    t0 = time.perf_counter()
    p_cpu = cpu.inference(image=frames, export_dir=export)
    cpu_s = time.perf_counter() - t0
    with highest_precision():
        p_gpu = gpu.inference(image=frames)
        torch.cuda.synchronize()
    errs = {}
    for field in ("depth", "conf", "extrinsics", "intrinsics"):
        a, b = getattr(p_gpu, field), getattr(p_cpu, field)
        if a.shape != b.shape or not np.isfinite(a).all():
            fail(f"nested parity: {field} shape {a.shape} vs {b.shape} or non-finite")
        errs[field] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))
    errs["metric_scale"] = abs(p_gpu.metric_scale - p_cpu.metric_scale) / abs(p_cpu.metric_scale)
    exported = np.load(export / "prediction.npz")
    pre_rescale = bool(np.array_equal(exported["depth"] * np.float32(p_cpu.metric_scale),
                                      p_cpu.depth))

    golden = WORK / "nested_golden.npz"
    np.savez(golden, processed_images=p_cpu.processed_images, depth=p_cpu.depth,
             conf=p_cpu.conf, extrinsics=p_cpu.extrinsics, intrinsics=p_cpu.intrinsics)
    ckpt = WORK / "nested_parity_ckpt"
    ckpt.mkdir(parents=True, exist_ok=True)
    save_file(export_torch_style_nested(cpu), ckpt / "model.safetensors")
    (ckpt / "config.json").write_text(json.dumps({
        "model": dataclasses.asdict(subs[0].cfg), "metric_model": dataclasses.asdict(subs[1].cfg)}))
    emit("nested_parity", tiers=["giant", "large"], depth_each=NESTED_PARITY_DEPTH,
         frames=len(frames), frame_seeds=NESTED_PARITY_FRAME_SEEDS, input_hw=518,
         processed_hw=list(p_gpu.depth.shape[1:]), layerscale=NESTED_PARITY_LAYERSCALE,
         depth_channel={"weight_scale": NESTED_DEPTH_WEIGHT_SCALE, "bias": NESTED_DEPTH_BIAS},
         relative_translation=p_cpu.extrinsics[1, :, 3].tolist(),
         depth_quantiles_01_50_99=np.quantile(p_cpu.depth / p_cpu.metric_scale,
                                              [0.01, 0.5, 0.99]).tolist(),
         metric_scale_cpu=p_cpu.metric_scale, metric_scale_card=p_gpu.metric_scale,
         max_rel_err=errs, tol=MODEL_PARITY_TOL, cpu_inference_s=cpu_s,
         export_dir_depth_is_before_the_rescale=pre_rescale)
    if not all(e <= MODEL_PARITY_TOL for e in errs.values()):
        fail(f"nested f32 parity beyond {MODEL_PARITY_TOL}: {errs}")
    if not pre_rescale:
        fail("nested parity: export_dir's depth is not the depth before the metric rescale")
    return ckpt, golden


def phase_parity_cli(ckpt: Path, golden: Path) -> None:
    """``cli/parity --checkpoint D --golden G`` on the card (bf16, the
    kernels) against phase 30's CPU golden of the same nested checkpoint:
    exit code 0 within ``DEFAULT_THRESHOLDS``; the metrics."""
    from da3slam_tpu_torch.cli import parity
    from da3slam_tpu_torch.utils.parity import DEFAULT_THRESHOLDS

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = parity.main(["--checkpoint", str(ckpt), "--golden", str(golden)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    metrics = {ln.split(":")[0].strip(): float(ln.split(":")[1])
               for ln in out.getvalue().splitlines() if ln.startswith("    ")}
    emit("parity_cli", rc=rc, metrics=metrics, thresholds=DEFAULT_THRESHOLDS, dtype="bfloat16",
         wall_s=wall, summary=out.getvalue().splitlines()[-1])
    if rc != 0:
        fail(f"parity CLI exit code {rc}: {out.getvalue()}")


def phase_main_conf(path_launches: dict) -> None:
    """``cli/main_conf --stats_only`` at SMALL (ray poses) over the first 8
    of the 31 frames: each frame's confidence statistics, 12 bound-forward
    launches.  The figures need matplotlib, which this machine lacks."""
    from da3slam_tpu_torch.cli import main_conf

    out = io.StringIO()
    with counted(path_launches, "main_conf"), contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        stats = main_conf.main(["--image_dir", str(frames_dir()), "--model", "small",
                                "--chunk_size", str(CONF_CHUNK), "--stats_only"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches["main_conf"]
    expected = expected_launches(flash_attn_bound_fwd=12)
    rows = [{k: (v.tolist() if isinstance(v, np.ndarray) else v) for k, v in s.items()
             if k in ("min", "max", "mean", "median", "counts")} for s in stats]
    emit("main_conf", preset="small", frames=CONF_CHUNK, wall_s=wall, stats=rows,
         kernel_launches=launches, expected_launches=expected)
    ok = len(stats) == CONF_CHUNK and all(
        np.isfinite([s["min"], s["max"], s["mean"], s["median"]]).all() and s["min"] >= 1.0
        and int(s["counts"].sum()) == 504 * 504 for s in stats)
    if not ok:
        fail(f"main_conf: statistics {rows}")
    if launches != expected:
        fail(f"main_conf: launches {launches} != {expected}")


def c3vd_sequence_dir() -> tuple[Path, np.ndarray, np.ndarray]:
    """A C3VD-layout sequence over phase 22's 31 frames (linked as
    ``NNNN_color.png``): 16-bit depth TIFFs of a smooth surface 10-90 mm away
    and a ``pose.txt`` of row-major c2w matrices in millimetres.  Returns the
    directory and the ground truth in metres (depth, c2w)."""
    import os

    from PIL import Image

    from da3slam_tpu_torch.inout.datasets import C3VD_DEPTH_SCALE_M

    seq = WORK / "c3vd_seq"
    seq.mkdir(parents=True, exist_ok=True)
    H, W = C3VD_HW
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    poses = np.tile(np.eye(4), (N_FRAMES, 1, 1))
    depth = np.empty((N_FRAMES, H, W), np.float32)
    for i, src in enumerate(sorted(c3vd_frames_dir().glob("*.jpg"))):
        link = seq / f"{i:04d}_color.png"
        if not link.exists():
            os.symlink(src, link)
        a = 0.02 * i
        poses[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        poses[i, :3, 3] = [1.5 * i, 0.4 * np.sin(0.3 * i), 0.2 * i]  # millimetres
        d = 0.05 + 0.03 * np.sin(xx / W * 3 + 0.1 * i) * np.cos(yy / H * 2)  # metres
        raw = np.round(d / C3VD_DEPTH_SCALE_M).astype(np.uint16)
        Image.fromarray(raw).save(seq / f"{i:04d}_depth.tiff")
        depth[i] = raw.astype(np.float32) * np.float32(C3VD_DEPTH_SCALE_M)
    (seq / "pose.txt").write_text("\n".join(",".join(f"{v:.9f}" for v in T.reshape(-1))
                                            for T in poses))
    gt = poses.copy()
    gt[:, :3, 3] *= 1e-3
    return seq, depth, gt


def phase_evaluate(nested_out: Path) -> None:
    """``cli/evaluate`` twice on the card: the nested tier's ``main_slam``
    trajectory against the SMALL main path's (sim3); and a C3VD-layout
    sequence with known answers: the estimate is the ground truth at half
    scale with 0.1 mm of seeded noise, and depth at 1.25x at 504x630 with 1%
    noise (resampled to 1080x1350 by the CLI).  Sim3 must recover the scale
    2 and median scaling 0.8, each within 1%."""
    from da3slam_tpu_torch.cli import evaluate
    from da3slam_tpu_torch.inout.trajectory import save_camera_poses
    from da3slam_tpu_torch.ops.resize import resize_bilinear

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        slam = evaluate.main(["--est", str(nested_out / "camera_poses.txt"),
                              "--gt", str(WORK / "out" / "camera_poses.txt"), "--align", "sim3"])
    slam_s = time.perf_counter() - t0

    seq, depth, gt = c3vd_sequence_dir()
    rng = np.random.default_rng(6)
    est = gt.copy()
    est[:, :3, 3] = 0.5 * gt[:, :3, 3] + rng.normal(scale=1e-4, size=(N_FRAMES, 3))
    save_camera_poses(WORK / "c3vd_est", est, np.tile(np.eye(3, dtype=np.float32),
                                                      (N_FRAMES, 1, 1)))
    small = resize_bilinear(torch.from_numpy(depth)[..., None], (504, 630))[..., 0].numpy()
    pred = (1.25 * small * rng.uniform(0.99, 1.01, small.shape)).astype(np.float32)
    np.save(WORK / "c3vd_est" / "depth.npy", pred)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        c3vd = evaluate.main(["--est", str(WORK / "c3vd_est" / "camera_poses.txt"),
                              "--gt_seq", str(seq),
                              "--depth_est", str(WORK / "c3vd_est" / "depth.npy")])
    c3vd_s = time.perf_counter() - t0
    emit("evaluate", nested_vs_main_path=slam, nested_vs_main_path_s=slam_s, c3vd=c3vd,
         c3vd_s=c3vd_s, c3vd_frames=N_FRAMES, c3vd_hw=list(C3VD_HW), depth_est_hw=[504, 630])
    if not all(np.isfinite(v) for v in slam["trajectory"].values()):
        fail(f"evaluate: the nested trajectory's scores {slam}")
    t, d = c3vd["trajectory"], c3vd["depth"]
    if not (abs(t["scale"] - 2.0) < 0.02 and abs(d["scale"] - 0.8) < 0.008
            and t["ate_rmse"] < 1e-3 and d["abs_rel"] < 0.02):
        fail(f"evaluate: the C3VD scores {c3vd} miss the known answers")


def _multi_net(preset: str):
    """``(cfg, net)``: the preset made on the card from seed 0, LayerScale
    MULTI_LAYERSCALE (see MULTI_CHUNK)."""
    from da3slam_tpu_torch.models.config import get_preset
    from da3slam_tpu_torch.models.da3 import init_params

    cfg = get_preset(preset)
    net = init_params(cfg, 0, device="cuda").eval()
    with torch.no_grad():
        for blk in net.blocks:
            blk.ls1.gamma.fill_(MULTI_LAYERSCALE)
            blk.ls2.gamma.fill_(MULTI_LAYERSCALE)
    return cfg, net


def _multi_kw() -> dict:
    from da3slam_tpu_torch.slam.alignment import AlignmentConfig

    return dict(chunk_size=MULTI_CHUNK, overlap=1, process_hw=(504, 504),
                align_config=AlignmentConfig(method="umeyama"))


def _held_bytes(*modules) -> int:
    return sum(t.numel() * t.element_size() for m in modules
               for t in (*m.parameters(), *m.buffers()))


def _multi_expected(cfg, mode: str, world: int) -> int:
    """Bound-forward launches a rank makes over the two windows: one a block a
    window it encodes, and in sp one a hop (``world`` of them) a cross-view
    block."""
    cross = sum(i % cfg.cross_view_interval == cfg.cross_view_interval - 1
                for i in range(cfg.depth))
    if mode == "dp":
        return cfg.depth * -(-MULTI_WINDOWS // world)
    if mode == "sp":
        return MULTI_WINDOWS * (cfg.depth - cross + cross * world)
    return MULTI_WINDOWS * cfg.depth // world


def _ring_check(group) -> list:
    """The card's ring (bound forward per hop, folded by lse) against its
    plain version (the JAX online softmax) on the card, at sp's hop shape:
    each rank's 8 views of 1301 tokens, 6 heads, bf16.  A ring that skipped
    its hops (the local block alone) must break the bound.  Every rank's row."""
    import torch.distributed as dist

    from da3slam_tpu_torch.parallel.ring_attention import (
        ring_attention_flash,
        ring_attention_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(10 + dist.get_rank(group))
    shape = (1, MULTI_CHUNK // MULTI_RANKS * 1301, 6, 64)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    o = ring_attention_flash(q, k, v, group)
    ref = ring_attention_reference(q, k, v, group)
    local = ring_attention_reference(q, k, v, None)
    row = {"shape": list(shape), "max_abs_err": (o.float() - ref.float()).abs().max().item(),
           "tol": BF16_REL_TOL * ref.float().abs().max().item(),
           "hopless_max_abs_err": (local.float() - ref.float()).abs().max().item(),
           "ms": cuda_ms(lambda: ring_attention_flash(q, k, v, group), reps=3),
           "plain_ms": cuda_ms(lambda: ring_attention_reference(q, k, v, group), reps=1)}
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, row, group=group)
    return out


def mesh_rank(preset: str, modes: list[str]) -> dict:
    """One rank of the multi-device phases (run by ``run_ranks``): for each
    mode, a mesh of every rank, the model (a pp rank keeps its stage only),
    one warm run of ``run_streaming_slam(mesh=...)`` over the 31 frames, then
    every launch count set to 0, the measured run, the counts read.  Rank 0
    returns the outputs and every rank's launches, host-staged bytes,
    parameter bytes, peak memory and wall time."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.parallel import comm, make_mesh
    from da3slam_tpu_torch.slam.pipeline import run_streaming_slam, split_params_pp

    world = dist.get_world_size()
    frames = make_frames(N_FRAMES)
    results = {}
    for mode in modes:
        cfg, net = _multi_net(preset)
        mesh = make_mesh() if mode == "dp" else \
            DeviceMesh("cuda", torch.arange(world), mesh_dim_names=(mode,))
        if mode == "pp":  # keep this rank's stage; the other blocks are freed
            net = split_params_pp(net, world, mesh)
            held = _held_bytes(net.stage_blocks, net.enc_rest, net.heads)
        else:
            held = _held_bytes(net)
        torch.cuda.empty_cache()
        kw = dict(_multi_kw(), mesh=mesh, parallel=mode)
        run_streaming_slam(net, frames, cfg, **kw)
        torch.cuda.synchronize()
        dist.barrier()
        for fn in counters().values():
            fn.launches = 0
        comm.host_bytes = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run_streaming_slam(net, frames, cfg, **kw)
        torch.cuda.synchronize()
        dist.barrier()
        stats = {"launches": {name: fn.launches for name, fn in counters().items()},
                 "host_bytes": comm.host_bytes, "param_bytes": held,
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 "wall_s": time.perf_counter() - t0}
        ranks = [None] * world
        dist.all_gather_object(ranks, stats)
        results[mode] = {"ranks": ranks, "out": [t.cpu().numpy() for t in out]
                         if dist.get_rank() == 0 else None}
        if mode == "sp":
            results[mode]["ring"] = _ring_check(mesh.get_group("sp"))
            with highest_precision():  # the f32 run, held to the single f32 run
                out32 = run_streaming_slam(net, frames, cfg, **dict(kw, dtype=torch.float32))
            results[mode]["f32_out"] = [t.cpu().numpy() for t in out32] \
                if dist.get_rank() == 0 else None
        del net, out
        torch.cuda.empty_cache()
    return results


def _multi_reference(path_launches: dict, preset: str) -> dict:
    """The single-process run the mesh phases are held to: the same model,
    frames and arguments with mesh=None (a warm run, then the counted one),
    and the same in f32 (TF32 off)."""
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.slam.pipeline import run_streaming_slam

    cfg, net = _multi_net(preset)
    frames = make_frames(N_FRAMES)
    with highest_precision():  # no TF32 in cuBLAS or cuDNN
        f32 = run_streaming_slam(net, frames, cfg, dtype=torch.float32, **_multi_kw())
    f32 = [t.cpu().numpy() for t in f32]
    run_streaming_slam(net, frames, cfg, **_multi_kw())  # warm, as the ranks are
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with counted(path_launches, f"mesh_reference_{preset}"):
        t0 = time.perf_counter()
        out = run_streaming_slam(net, frames, cfg, **_multi_kw())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = path_launches[f"mesh_reference_{preset}"]
    if launches != expected_launches(flash_attn_bound_fwd=MULTI_WINDOWS * cfg.depth):
        fail(f"mesh reference {preset}: launches {launches}")
    ref = {"out": [t.cpu().numpy() for t in out], "f32": f32, "wall_s": wall, "cfg": cfg,
           "preset": preset,
           "param_bytes": _held_bytes(net), "peak_bytes": torch.cuda.max_memory_allocated()}
    del net, out
    torch.cuda.empty_cache()
    return ref


def _emit_mesh(path_launches: dict, phase: str, mode: str, backend: str, res: dict, ref: dict,
               spawn_s: float, require_bit_equal: bool) -> None:
    from da3slam_tpu_torch.slam.pipeline import PipelineOutput

    cfg, world = ref["cfg"], len(res["ranks"])
    errs, ok = {}, True
    for name, a, b, b32 in zip(PipelineOutput._fields, res["out"], ref["out"], ref["f32"]):
        if a.shape != b.shape or not np.isfinite(a).all():
            fail(f"{phase}: {name} shape {a.shape} vs {b.shape} or non-finite")
        diff = float(np.abs(a.astype(np.float64) - b).max())
        bf16_vs_f32 = float(np.abs(b.astype(np.float64) - b32).max())
        errs[name] = {"max_abs": diff, "rel": diff / max(float(np.abs(b).max()), 1e-30),
                      "single_bf16_vs_f32": bf16_vs_f32, "tol": MULTI_TRIANGLE * bf16_vs_f32}
        ok = ok and diff <= MULTI_TRIANGLE * bf16_vs_f32
    bit_equal = all(np.array_equal(a, b) for a, b in zip(res["out"], ref["out"]))
    f32 = None  # sp in f32 against the single f32 run: the ring's own f32 bound
    if res.get("f32_out") is not None:
        f32 = {name: {"rel": float(np.abs(a.astype(np.float64) - b).max()
                                   / max(float(np.abs(b).max()), 1e-30)),
                      "tol": MODEL_PARITY_TOL}
               for name, a, b in zip(PipelineOutput._fields, res["f32_out"], ref["f32"])}
    want = expected_launches(flash_attn_bound_fwd=_multi_expected(cfg, mode, world))
    for r, st in enumerate(res["ranks"]):
        path_launches[f"{phase}.rank{r}"] = st["launches"]
    wall = max(st["wall_s"] for st in res["ranks"])
    emit(phase, preset=ref["preset"], mode=mode, backend=backend,
         ranks=world, frames=N_FRAMES, chunk_size=MULTI_CHUNK, windows=MULTI_WINDOWS,
         dtype="bfloat16", layerscale=MULTI_LAYERSCALE, align="umeyama",
         vs_single_process=errs, bit_equal=bit_equal,
         launches_per_rank=[st["launches"]["flash_attn_bound_fwd"] for st in res["ranks"]],
         expected_launches_per_rank=want["flash_attn_bound_fwd"],
         host_staged_bytes_per_rank=[st["host_bytes"] for st in res["ranks"]],
         param_bytes_per_rank=[st["param_bytes"] for st in res["ranks"]],
         peak_bytes_per_rank=[st["peak_bytes"] for st in res["ranks"]],
         wall_s=wall, frames_per_s=N_FRAMES / wall,
         wall_note=(f"{world} ranks time-sharing one card: not a scaling measurement"
                    if world > 1 else "one rank"),
         single_process_wall_s=ref["wall_s"], single_process_frames_per_s=N_FRAMES / ref["wall_s"],
         single_process_param_bytes=ref["param_bytes"],
         single_process_peak_bytes=ref["peak_bytes"],
         spawn_s=spawn_s, ring=res.get("ring"), f32_vs_single_f32=f32)
    for r, st in enumerate(res["ranks"]):
        if st["launches"] != want:
            fail(f"{phase}: rank {r} launches {st['launches']} != {want}")
    if not ok:
        fail(f"{phase}: beyond the bf16 bound of the single-process run: {errs}")
    if require_bit_equal and not bit_equal:
        fail(f"{phase}: not bit-equal to the single-process run: {errs}")
    if f32 is not None and not all(e["rel"] <= e["tol"] for e in f32.values()):
        fail(f"{phase}: the f32 run beyond MODEL_PARITY_TOL of the single f32 run: {f32}")
    for row in res.get("ring") or []:
        if not row["max_abs_err"] <= row["tol"] < row["hopless_max_abs_err"]:
            fail(f"{phase}: ring against its plain version {row}")


def phase_mesh(path_launches: dict) -> dict:
    """34-36. mesh_dp, mesh_sp, mesh_pp: SMALL on two gloo ranks sharing the
    card (one spawn for the three), each held to the single-process run."""
    from da3slam_tpu_torch.ops.flash_attention import build_kernel
    from da3slam_tpu_torch.parallel import run_ranks

    build_kernel()  # in this process, before the ranks look for it
    ref = _multi_reference(path_launches, "small")
    t0 = time.perf_counter()
    res = run_ranks(mesh_rank, MULTI_RANKS, "gloo", "cuda", MULTI_TIMEOUT_S, "small",
                    ["dp", "sp", "pp"])
    spawn_s = time.perf_counter() - t0
    for mode in ("dp", "sp", "pp"):
        _emit_mesh(path_launches, f"mesh_{mode}", mode, "gloo", res[mode], ref, spawn_s,
                   require_bit_equal=False)
    return ref


def phase_mesh_nccl(path_launches: dict, ref: dict) -> None:
    """37. mesh_nccl: dp on one NCCL rank, bit-equal to the single-process run."""
    from da3slam_tpu_torch.parallel import run_ranks

    t0 = time.perf_counter()
    res = run_ranks(mesh_rank, 1, "nccl", "cuda", MULTI_TIMEOUT_S, "small", ["dp"])
    _emit_mesh(path_launches, "mesh_nccl", "dp", "nccl", res["dp"], ref,
               time.perf_counter() - t0, require_bit_equal=True)


def phase_mesh_pp_giant(path_launches: dict) -> None:
    """38. mesh_pp_giant: the giant tier (40 blocks, SwiGLU) in two stages of
    20 on two gloo ranks, each holding its stage only."""
    from da3slam_tpu_torch.parallel import run_ranks

    ref = _multi_reference(path_launches, "giant")
    t0 = time.perf_counter()
    res = run_ranks(mesh_rank, MULTI_RANKS, "gloo", "cuda", MULTI_TIMEOUT_S, "giant", ["pp"])
    _emit_mesh(path_launches, "mesh_pp_giant", "pp", "gloo", res["pp"], ref,
               time.perf_counter() - t0, require_bit_equal=False)


def _train_cfg(mode: str):
    from da3slam_tpu_torch.models.config import get_preset

    if mode == "giant_tp":
        return get_preset("giant").with_overrides(depth=TRAIN_GIANT_DEPTH,
                                                  dpt_layers=tuple(range(TRAIN_GIANT_DEPTH)))
    return get_preset("small")


def _train_args(mode: str):
    from da3slam_tpu_torch.cli import train as cli_train

    return cli_train.build_parser().parse_args(TRAIN_MESH_COMMON + TRAIN_MESH_ARGS[mode])


def _train_mesh_launches(cfg, mode: str, world: int) -> dict:
    """Launches of the bound forward, dq and dk/dv a rank makes over a mode's
    run: one each a block a window it encodes, and in sp one each a hop
    (``world``) a cross-view block (remat off)."""
    args = _train_args(mode)
    cross = sum(i % cfg.cross_view_interval == cfg.cross_view_interval - 1
                for i in range(cfg.depth))
    if mode == "sp":
        per_step = cfg.depth - cross + cross * world
    elif mode == "pp":
        per_step = cfg.depth // world * args.batch
    else:  # dp: this rank's windows
        per_step = cfg.depth * args.batch // (world // (args.tp or 1))
    n = args.steps * per_step
    return expected_launches(flash_attn_bound_fwd=n, flash_attn_bwd_dq=n, flash_attn_bwd_dkv=n)


def _condition(net) -> None:
    """TRAIN_GRAD_LAYERSCALE, the camera output layer x300 and the DPT biases
    DPT_BIAS, on whatever part of the network ``net`` holds (replicated
    parameters only, so a shard is conditioned as the whole is)."""
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(("ls1.gamma", "ls2.gamma")):
                p.fill_(TRAIN_GRAD_LAYERSCALE)
            elif name == "camera_head.out.weight":
                p.mul_(300.0)
        for m in net.depth_head.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                m.bias.fill_(DPT_BIAS)


def _grad_batch(args) -> dict:
    """The gradient check's batch (random target poses), in the mode's step
    contract."""
    from da3slam_tpu_torch.cli.train import _shape_batch
    from da3slam_tpu_torch.parallel.train import synthetic_batch

    b = synthetic_batch(None, args.batch, args.views, tuple(args.hw), seed=TRAIN_GRAD_SEED)
    b["extrinsics"] = b["extrinsics"] + np.random.default_rng(9).normal(
        scale=0.3, size=b["extrinsics"].shape).astype(np.float32)
    return _shape_batch(args.mode, b)


def _single_grads(cfg, mode: str, batch: dict) -> tuple[float, dict]:
    """The single-process step's loss and gradients on the card (highest
    precision) from the same weights (seed and conditioning) and batch: the
    mode's loss over the whole network on one device."""
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.models import dpt, vit
    from da3slam_tpu_torch.models.da3 import init_params
    from da3slam_tpu_torch.parallel.train import depth_loss, window_loss

    net = init_params(cfg, TRAIN_GRAD_SEED).to("cuda")
    _condition(net)
    b = {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}
    with highest_precision():
        if mode == "sp":
            loss = window_loss(net, cfg, b["images"], b["depth"], b["extrinsics"])
        elif mode == "pp":
            M, N, H, W, _ = b["images"].shape
            heads = []
            for m in range(M):
                taps, _, grid = vit.encode(net, b["images"][m], cfg)
                heads.append(dpt.apply_dpt(net.depth_head, taps, grid, (H, W), cfg)[:2])
            loss = depth_loss(torch.cat([d for d, _ in heads]), torch.cat([c for _, c in heads]),
                              b["depth"].reshape(M * N, H, W))
        else:
            n = b["images"].shape[0]
            loss = sum(window_loss(net, cfg, b["images"][w], b["depth"][w], b["extrinsics"][w])
                       for w in range(n)) / n
        loss.backward()
    return loss.item(), {n: p.grad for n, p in net.named_parameters()}


def _one_device_step(cfg, batch: dict) -> tuple[float, dict]:
    """``make_train_step`` without a mesh from the conditioned weights: the
    step's loss and gradients (highest precision)."""
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.parallel.train import make_train_step

    init_fn, step_fn, place = make_train_step(cfg, "cuda")
    state = init_fn(seed=TRAIN_GRAD_SEED)
    _condition(state.net)
    with highest_precision():
        state, loss = step_fn(state, place(batch))
    return loss.item(), {n: p.grad for n, p in state.net.named_parameters()}


def _grad_check(cfg, mode: str, args, shape: dict) -> dict | None:
    """One step of the mode's step function (``cli/train._step_factory``)
    from the conditioned weights on every rank; rank 0 holds every gradient,
    put back together over the ranks, to the single-process step's."""
    import torch.distributed as dist

    from da3slam_tpu_torch.cli.train import _step_factory
    from da3slam_tpu_torch.core.transforms import highest_precision

    init_fn, step_fn, place = _step_factory(args, cfg, shape, torch.device("cuda"))
    state = init_fn(seed=TRAIN_GRAD_SEED)
    _condition(state.net)
    batch = _grad_batch(args)
    with highest_precision():
        state, loss = step_fn(state, place(batch))
    whole = state.layout.gather({state.layout.whole_name(n): p.grad
                                 for n, p in state.net.named_parameters()})
    del state
    if dist.get_rank() != 0:
        return None
    ref_loss, ref = _single_grads(cfg, mode, batch)
    zero, bad = 0, []
    worst = {"max_rel": (0.0, None), "blocks_max_rel": (0.0, None), "rel_l2": (0.0, None),
             "head_rel_l2": (0.0, None)}
    # at giant width the DPT head's ReLU inputs spread over tens, where
    # DPT_BIAS does not keep them off 0: its gradients are reported apart
    head_apart = mode == "giant_tp"
    for name, g in whole.items():
        r = ref[name]
        if r is None:  # never read by the loss (the unused DPT unit)
            bad += [name] if g.abs().max().item() else []
            zero += 1
            continue
        g = g.to(r.device)
        scale = r.abs().max().item()
        if scale == 0.0:
            zero += 1
            bad += [name] if (g - r).abs().max().item() else []
            continue
        l2 = ((g - r).double().norm() / r.double().norm()).item()
        in_head = head_apart and name.startswith("depth_head.")
        errs = {"max_rel": (g - r).abs().max().item() / scale,
                "rel_l2": 0.0 if in_head else l2, "head_rel_l2": l2 if in_head else 0.0}
        errs["blocks_max_rel"] = errs["max_rel"] if name.startswith("blocks.") else 0.0
        for key, e in errs.items():
            if e > worst[key][0]:
                worst[key] = (e, name)
    out = {}
    if mode == "nccl":
        # the mesh step on a (1, 1) mesh runs the one-device step's operations:
        # bit-equal to it, as far as the one-device step is to itself (run twice)
        (loss_a, a), (loss_b, b) = _one_device_step(cfg, batch), _one_device_step(cfg, batch)
        def rel(x, y):  # largest |x - y| of a parameter over its largest |y|
            return max(((x[n] - y[n]).abs().max() / y[n].abs().max().clamp_min(1e-30)).item()
                       for n in whole)

        out["one_device_repeat_max_rel"] = rel(b, a)
        out["one_device_repeatable"] = loss_a == loss_b and out["one_device_repeat_max_rel"] == 0
        out["vs_one_device_max_rel"] = rel(whole, a)
        out["bit_equal_to_one_device_step"] = loss_a == loss.item() and \
            out["vs_one_device_max_rel"] == 0
    return {**out, "loss": loss.item(), "single_loss": ref_loss, "params": len(whole),
            "params_zero_grad": zero, "zero_in_single_not_here": bad,
            **{key: e for key, (e, _) in worst.items()},
            **{f"{key}_param": n for key, (_, n) in worst.items()}, "tol": MODEL_PARITY_TOL}


def _ring_backward_check() -> list:
    """The ring's backward (the dq and dk/dv kernels a hop, from the bound
    forward ring's global lse) against its plain version (the same hops
    through the kernels' plain versions, on the card) at sp's hop shape, f32
    and bf16; the plain version without its hops (this rank's block alone)
    must break the bound.  Every rank's rows."""
    import torch.distributed as dist

    from da3slam_tpu_torch.ops.flash_attention import (
        flash_attention_bound,
        flash_attention_bwd_dkv_reference,
        flash_attention_bwd_dq_reference,
    )
    from da3slam_tpu_torch.parallel.ring_attention import _ring_lse, ring_attention_backward

    group = dist.group.WORLD
    plain = (flash_attention_bwd_dq_reference, flash_attention_bwd_dkv_reference)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        gen = torch.Generator(device="cuda").manual_seed(20 + dist.get_rank())
        q, k, v, do = (torch.randn(TRAIN_RING_SHAPE, generator=gen, device="cuda").to(dtype)
                       for _ in range(4))
        o, lse = _ring_lse(q, k, v, group, flash_attention_bound)
        got = ring_attention_backward(q, k, v, o, lse, do, group)
        ref = ring_attention_backward(q, k, v, o, lse, do, group, *plain)
        hopless = ring_attention_backward(q, k, v, o, lse, do, None, *plain)
        row = {"dtype": str(dtype).replace("torch.", ""), "shape": list(TRAIN_RING_SHAPE)}
        for name, a, b, c in zip(("dq", "dk", "dv"), got, ref, hopless):
            row[name] = {"max_abs_err": (a.float() - b.float()).abs().max().item(),
                         "tol": grad_bound(b),
                         "hopless_max_abs_err": (c.float() - b.float()).abs().max().item()}
        row["ms"] = cuda_ms(lambda: ring_attention_backward(q, k, v, o, lse, do, group), reps=3)
        row["plain_ms"] = cuda_ms(lambda: ring_attention_backward(q, k, v, o, lse, do, group,
                                                                  *plain), reps=1)
        rows.append(row)
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, rows)
    return out


def _digest(tensors) -> str:
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _replicated_names(mode: str, names: list[str]) -> list[str]:
    """The parameters every rank of the mode holds whole."""
    from da3slam_tpu_torch.parallel.sharding import replicated

    if mode == "pp":
        return [n for n in names if not n.startswith("blocks.")]
    return [n for n in names if replicated(n)]


def _run_mode(cfg, mode: str, args, shape: dict):
    """The mode's counted run: cli/train's loop, or for giant_tp (the CLI has
    no depth flag) one step of the step function the CLI builds.  Returns
    ``(state, losses, rank 0's JSON lines)``."""
    from da3slam_tpu_torch.cli import train as cli_train

    if mode != "giant_tp":
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            state, losses = cli_train._train(args, shape)
        return state, losses, out.getvalue().splitlines()
    init_fn, step_fn, place = cli_train._step_factory(args, cfg, shape, torch.device("cuda"))
    state = init_fn(seed=args.seed)
    batch = place(_grad_batch(args))
    t0 = time.perf_counter()
    state, loss = step_fn(state, batch)
    return state, [loss.item()], [json.dumps({"step": 1, "loss": loss.item(),
                                              "steps_per_s": 1 / (time.perf_counter() - t0)})]


def train_rank(modes: list[str]) -> dict:
    """One rank of the multi-device training phases (run by ``run_ranks``):
    for each mode, its run with every launch count and the host-byte count
    set to 0 just before and read just after, then the gradient check, and
    for sp the ring's backward check.  Rank 0 returns every rank's stats."""
    import torch.distributed as dist

    from da3slam_tpu_torch.cli.train import _mesh_shape
    from da3slam_tpu_torch.models.da3 import DA3Net
    from da3slam_tpu_torch.parallel import comm

    results = {}
    for mode in modes:
        cfg, args = _train_cfg(mode), _train_args(mode)
        shape = _mesh_shape(args, cfg)
        torch.cuda.synchronize()
        dist.barrier()
        for fn in counters().values():
            fn.launches = 0
        comm.host_bytes = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, losses, lines = _run_mode(cfg, mode, args, shape)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters().items()}
        host = comm.host_bytes
        named = dict(state.net.named_parameters())
        opt = state.optimizer.state
        stats = {"launches": launches, "host_bytes": host, "wall_s": wall,
                 "param_bytes": sum(p.numel() * p.element_size() for p in named.values()),
                 "moment_bytes": sum(t.numel() * t.element_size() for st in opt.values()
                                     for key, t in st.items() if key != "step"),
                 "peak_bytes": torch.cuda.max_memory_allocated(),
                 "replicated_digest": _digest(named[n] for n in _replicated_names(
                     mode, list(named))),
                 "blocks": sorted({int(state.layout.whole_name(n).split(".")[1])
                                   for n in named if n.startswith("blocks.")})}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, stats)
        del state, named, opt
        torch.cuda.empty_cache()
        with torch.device("meta"):
            whole = DA3Net(cfg)
        res = {"ranks": ranks, "losses": losses, "lines": lines, "shape": shape,
               "whole_param_bytes": sum(p.numel() * 4 for p in whole.parameters()),
               "grads": _grad_check(cfg, mode, args, shape)}
        if mode == "sp":
            res["ring"] = _ring_backward_check()
        results[mode] = res
        torch.cuda.empty_cache()
    return results if dist.get_rank() == 0 else None


def _emit_train_mesh(path_launches: dict, mode: str, backend: str, res: dict,
                     spawn_s: float) -> None:
    cfg, world = _train_cfg(mode), len(res["ranks"])
    phase = f"train_{mode}"
    want = _train_mesh_launches(cfg, mode, world)
    for r, st in enumerate(res["ranks"]):
        path_launches[f"{phase}.rank{r}"] = st["launches"]
    lines = [json.loads(ln) for ln in res["lines"] if ln.startswith("{")]
    steps_per_s = [ln["steps_per_s"] for ln in lines if "steps_per_s" in ln]
    digests = {st["replicated_digest"] for st in res["ranks"]}
    g = res["grads"]
    emit(phase, preset="giant (cut)" if mode == "giant_tp" else "small", backend=backend,
         ranks=world, mesh=res["shape"], args=TRAIN_MESH_COMMON + TRAIN_MESH_ARGS[mode],
         losses=res["losses"], cli_lines=lines,
         steps_per_s=steps_per_s[-1] if steps_per_s else None,
         steps_per_s_note=(f"{world} ranks time-sharing one card: function, not scaling"
                           if world > 1 else "one rank"),
         launches_per_rank=[{k: v for k, v in st["launches"].items() if v}
                            for st in res["ranks"]],
         expected_launches_per_rank={k: v for k, v in want.items() if v},
         host_bytes_per_rank=[st["host_bytes"] for st in res["ranks"]],
         param_bytes_per_rank=[st["param_bytes"] for st in res["ranks"]],
         moment_bytes_per_rank=[st["moment_bytes"] for st in res["ranks"]],
         whole_param_bytes=res["whole_param_bytes"],
         peak_bytes_per_rank=[st["peak_bytes"] for st in res["ranks"]],
         wall_s_per_rank=[st["wall_s"] for st in res["ranks"]],
         blocks_per_rank=[st["blocks"] for st in res["ranks"]],
         replicated_bit_equal=len(digests) == 1, grads=g, spawn_s=spawn_s,
         ring_backward=res.get("ring"))
    if len(res["losses"]) != _train_args(mode).steps or not all(np.isfinite(res["losses"])):
        fail(f"{phase}: losses {res['losses']}")
    for r, st in enumerate(res["ranks"]):
        if st["launches"] != want:
            fail(f"{phase}: rank {r} launches {st['launches']} != {want}")
    if len(digests) != 1:
        fail(f"{phase}: replicated parameters differ across the ranks")
    if g["zero_in_single_not_here"] or not (g["rel_l2"] <= g["tol"]
                                            and g["blocks_max_rel"] <= g["tol"]):
        fail(f"{phase}: gradients against the single-process step: {g}")
    if mode == "nccl" and g["vs_one_device_max_rel"] > 2 * g["one_device_repeat_max_rel"]:
        fail(f"{phase}: further from the one-device step than it is from itself: {g}")
    if mode == "pp" and [st["blocks"] for st in res["ranks"]] != [
            list(range(s * cfg.depth // world, (s + 1) * cfg.depth // world))
            for s in range(world)]:
        fail(f"{phase}: stage blocks {[st['blocks'] for st in res['ranks']]}")
    for rows in res.get("ring") or []:
        for row in rows:
            for name in ("dq", "dk", "dv"):
                e = row[name]
                if not e["max_abs_err"] <= e["tol"] < e["hopless_max_abs_err"]:
                    fail(f"{phase}: the ring's backward against its plain version {row}")


def phase_train_mesh(path_launches: dict) -> None:
    """39-44. train_tp, train_sp, train_pp, train_giant_tp on two gloo ranks
    sharing the card (one spawn), train_tp4 on four, train_nccl on one NCCL
    rank; each held to the single-process step."""
    from da3slam_tpu_torch.ops.flash_attention import build_kernel
    from da3slam_tpu_torch.parallel import run_ranks

    build_kernel()  # in this process, before the ranks look for it
    for world, backend, modes in ((2, "gloo", ["tp", "sp", "pp", "giant_tp"]),
                                  (4, "gloo", ["tp4"]), (1, "nccl", ["nccl"])):
        t0 = time.perf_counter()
        res = run_ranks(train_rank, world, backend, "cuda", TRAIN_MESH_TIMEOUT_S, modes)
        spawn_s = time.perf_counter() - t0
        for mode in modes:
            _emit_train_mesh(path_launches, mode, backend, res[mode], spawn_s)


# ---------------------------------------------------------------------------
# The last modules (phases 45-51): the viewer on main_slam and main_align,
# main_video, the one-shot viewer, the profiler trace, the confidence
# figures and the native point-cloud library
# ---------------------------------------------------------------------------

# a viewer point against its host recomputation in f64 (from the fetched
# depth, intrinsics and global extrinsics): f32 backprojection, rotation and
# translation round a few times, each within 2^-24 of the largest coordinate;
# 1e-5 of it is ~170 roundings
VIEWER_POINT_REL_TOL = 1e-5
# host waits the viewer may add a chunk: its one device->host transfer
VIEWER_WAITS_PER_CHUNK = 1
# SMALL main_slam over the 31 frames: chunks of 15, overlap 1 (3 chunks)
VIEWER_CHUNKS = 3
# main_video's frames: the 31 generated ones, written as the decoder would
VIDEO_STREAM_CHUNK, VIDEO_STREAM_OVERLAP = 16, 4  # cli/streaming's defaults
# LARGE main_align's fused cloud at 15-frame chunks: the native PLY cell
NATIVE_POINTS = 11_430_720
NATIVE_VOXEL_POINTS, NATIVE_VOXEL = 1_000_000, 0.05
# voxel centroids against the numpy reference of the C++ arithmetic: f64
# sums of the same points in the same order, one f32 rounding of the mean
NATIVE_VOXEL_TOL = 1e-6
# the C++ 3DGS pass against the numpy path (tests/test_native.py's bound:
# the compiler contracts multiply-adds there)
NATIVE_GS_TOL = 5e-6
PROFILE_KERNEL = "flash_fwd_wgmma_kernel"


class _Handle:
    """A recording stand-in for a viser scene or GUI handle."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.removed = False
        self.callbacks = []

    def remove(self):
        self.removed = True

    def on_update(self, fn):
        self.callbacks.append(fn)
        return fn

    on_click = on_update


class _StubGui:
    def __init__(self):
        self.handles = {}

    def add_slider(self, name, min, max, step, initial_value):
        self.handles[name] = _Handle(value=initial_value, options=None)
        return self.handles[name]

    def add_dropdown(self, name, options, initial_value):
        self.handles[name] = _Handle(value=initial_value, options=list(options))
        return self.handles[name]


class _StubScene:
    def __init__(self):
        self.clouds, self.frusta, self.meshes = [], [], []

    def add_point_cloud(self, name, points, colors, point_size):
        self.clouds.append(_Handle(name=name, points=points, colors=colors,
                                   point_size=point_size))
        return self.clouds[-1]

    def add_camera_frustum(self, name, fov, aspect, scale, wxyz, position, image):
        self.frusta.append(_Handle(name=name, fov=fov, aspect=aspect, wxyz=wxyz,
                                   position=position, image=image))
        return self.frusta[-1]

    def add_mesh(self, name, vertices, faces, colors):
        self.meshes.append(_Handle(name=name, vertices=vertices, faces=faces, colors=colors))
        return self.meshes[-1]

    def add_mesh_simple(self, name, vertices, faces, color):
        self.meshes.append(_Handle(name=name, vertices=vertices, faces=faces, color=color))
        return self.meshes[-1]


@contextlib.contextmanager
def stub_viser():
    """A recording ``viser`` module in ``sys.modules`` (the card has no
    viser): ``ViserServer`` records every scene call; the servers made are
    yielded in a list.  Removed on exit."""
    import types

    servers = []

    class ViserServer:
        def __init__(self, host, port):
            self.host, self.port = host, port
            self.gui, self.scene = _StubGui(), _StubScene()
            servers.append(self)

        def get_clients(self):
            return {}

    saved = sys.modules.get("viser")
    stub = types.ModuleType("viser")
    stub.ViserServer = ViserServer
    sys.modules["viser"] = stub
    try:
        yield servers
    finally:
        if saved is None:
            sys.modules.pop("viser", None)
        else:
            sys.modules["viser"] = saved


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@contextlib.contextmanager
def recorded_viewer_inputs():
    """Every ``SLAMViewer.add_frames`` call's inputs (references; fetched
    after the run) with the index of its first frame, and every
    ``SLAMSolver.update_viewer`` call's host waits (and the thread and Python
    line each was reported at)."""
    from da3slam_tpu_torch.slam.solver import SLAMSolver
    from da3slam_tpu_torch.viz.viewer import SLAMViewer

    calls, waits = [], []
    where: dict[str, int] = {}

    def make_add(orig):
        def add_frames(self, images, depth, conf, extrinsics, intrinsics):
            calls.append((self, self._frame_count, (images, depth, conf, extrinsics, intrinsics)))
            return orig(self, images, depth, conf, extrinsics, intrinsics)
        return add_frames

    def make_update(orig):
        def update_viewer(self, chunk_prediction, start=0):
            import threading

            reported = []

            def show(message, category, filename, lineno, file=None, line=None):
                if "synchroniz" in str(message):
                    reported.append(f"{threading.current_thread().name} "
                                  f"{Path(filename).name}:{lineno}")

            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                torch.cuda.set_sync_debug_mode("warn")
                reported.clear()  # switching the mode on may report a wait of its own
                try:
                    orig(self, chunk_prediction, start)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            waits.append(len(reported))
            for st in reported:
                where[st] = where.get(st, 0) + 1
        return update_viewer

    with patched(SLAMViewer, "add_frames", make_add), \
            patched(SLAMSolver, "update_viewer", make_update):
        yield calls, waits, where


def _host_cloud(depth, K, E, stride, min_depth, max_depth):
    """The viewer's cloud of one frame recomputed on the host in f64, from
    the same f32 depth (validity tested in f32, as on the card)."""
    d = np.asarray(depth, np.float32)
    H, W = d.shape
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    K = np.asarray(K, np.float64)
    z = d.astype(np.float64)
    cam = np.stack([(u - K[0, 2]) / K[0, 0] * z, (v - K[1, 2]) / K[1, 1] * z, z], -1)
    E = np.asarray(E, np.float32).astype(np.float64)
    world = (cam - E[:3, 3]) @ E[:3, :3]
    pts = world[::stride, ::stride].reshape(-1, 3)
    ds = d[::stride, ::stride].reshape(-1)
    valid = (np.isfinite(pts).all(-1) & (ds > np.float32(min_depth))
             & (ds < np.float32(max_depth)))
    return pts[valid], valid


def check_viewer_clouds(calls) -> dict:
    """Each frame the viewers took against the host recomputation: the same
    points kept, within VIEWER_POINT_REL_TOL of the frame's largest
    coordinate, the same colours; each frustum at the frame's camera centre."""
    worst, n_frames, n_points = 0.0, 0, 0
    for viewer, first, (images, depth, conf, ext, intr) in calls:
        images, depth, ext, intr = (_host(a) for a in (images, depth, ext, intr))
        for i in range(len(depth)):
            idx = first + i
            pts, valid = _host_cloud(depth[i], intr[i], ext[i], viewer.point_stride,
                                     viewer.min_depth, viewer.max_depth)
            got = viewer.all_points[idx]
            s = viewer.point_stride
            cols = images[i][::s, ::s].reshape(-1, 3)[valid]
            if got.shape != pts.shape or not np.array_equal(viewer.all_colors[idx], cols):
                fail(f"viewer frame {idx}: {got.shape[0]} points, the host keeps {pts.shape[0]} "
                     "(or the colours differ)")
            scale = max(1.0, float(np.abs(pts).max(initial=0.0)))
            err = float(np.abs(got - pts).max(initial=0.0)) / scale
            E = ext[i].astype(np.float64)
            center = -E[:3, :3].T @ E[:3, 3]
            pos = np.asarray(viewer.cam_poses[idx][1], np.float64)
            err = max(err, float(np.abs(pos - center).max()) / max(1.0, np.abs(center).max()))
            worst, n_frames, n_points = max(worst, err), n_frames + 1, n_points + len(pts)
    if not worst <= VIEWER_POINT_REL_TOL:
        fail(f"viewer: a cloud or frustum {worst} (relative) from the host recomputation "
             f"(bound {VIEWER_POINT_REL_TOL})")
    return {"frames": n_frames, "points": n_points, "max_rel_err": worst,
            "tol": VIEWER_POINT_REL_TOL}


def _viewer_solver_run(model, config: dict, viewer) -> tuple:
    """One SLAMSolver run over the 31 frames: (solver, run seconds)."""
    from da3slam_tpu_torch.slam.solver import SLAMSolver

    with contextlib.redirect_stdout(io.StringIO()):
        solver = SLAMSolver(str(frames_dir()), config, model=model, viewer=viewer,
                            device=torch.device("cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.run()
        torch.cuda.synchronize()
    return solver, time.perf_counter() - t0


def phase_main_slam_viewer(path_launches: dict) -> None:
    """45. main_slam_viewer: ``SLAMSolver(viewer="auto")`` (device-resident,
    ICP) and then ``cli/main_slam`` without ``--headless`` (its default
    config: every chunk fetched), each through the recording stub viser:
    31 frames reach the viewer, each cloud and frustum equal to the host
    recomputation from the fetched depth, intrinsics and global extrinsics,
    the frusta at ``solver.trajectory()``'s centres, 36 bound-forward
    launches a run, at most VIEWER_WAITS_PER_CHUNK host wait a chunk in
    ``update_viewer``; frames/s with the viewer beside the same solver
    headless, in turns (not counted, not recorded).  The CLI stays alive
    after its run: the phase ends that loop through the module's
    ``time.sleep``."""
    import types

    from da3slam_tpu_torch.cli import main_slam
    from da3slam_tpu_torch.models.da3 import DepthAnything3

    resident = {"Weights": {"DA3": "small"},
                "Model": {**main_slam.DEFAULT_CONFIG["Model"], "device_resident": True}}
    model = DepthAnything3.from_pretrained("small", device=torch.device("cuda"))
    with stub_viser() as servers:
        with recorded_viewer_inputs() as (calls, waits, where), \
                counted(path_launches, "main_slam_viewer"):
            solver, _ = _viewer_solver_run(model, resident, "auto")
            solver_waits, solver_where = list(waits), dict(where)
        if solver.viewer is None or len(servers) != 1:
            fail("main_slam_viewer: the solver did not open the stub viewer")
        clouds = check_viewer_clouds(calls)
        c2w, _ = solver.trajectory()
        centres = np.stack([p for _, p in solver.viewer.cam_poses]).astype(np.float64)
        traj_err = float(np.abs(centres - c2w[:, :3, 3]).max())
        rates = []
        for tag in ("headless", "viewer", "viewer", "headless"):
            _, run_s = _viewer_solver_run(model, resident, None if tag == "headless" else "auto")
            rates.append((tag, N_FRAMES / run_s))
        del model
        out_dir = WORK / "out_viewer"

        def interrupt(_s):
            raise KeyboardInterrupt

        saved_time = main_slam.time
        main_slam.time = types.SimpleNamespace(sleep=interrupt)
        try:
            with recorded_viewer_inputs() as (calls, waits, where), \
                    counted(path_launches, "main_slam_viewer_cli"), \
                    contextlib.redirect_stdout(io.StringIO()) as out:
                cli_solver = main_slam.main(["--image_dir", str(frames_dir()),
                                             "--output_dir", str(out_dir)])
                cli_waits, cli_where = list(waits), dict(where)
        finally:
            main_slam.time = saved_time
        cli_clouds = check_viewer_clouds(calls)
    poses = np.loadtxt(out_dir / "camera_poses.txt", ndmin=2)
    expected = expected_launches(flash_attn_bound_fwd=EXPECTED_LAUNCHES)
    launches = {k: path_launches[k] for k in ("main_slam_viewer", "main_slam_viewer_cli")}
    headless = [r for t, r in rates if t == "headless"]
    viewer_rates = [r for t, r in rates if t == "viewer"]
    emit("main_slam_viewer", frames=N_FRAMES, solver_clouds=clouds, cli_clouds=cli_clouds,
         frusta_vs_trajectory_max_abs=traj_err,
         viewer_host_waits_per_chunk={"solver_resident": solver_waits, "cli": cli_waits},
         viewer_host_waits_at={"solver_resident": solver_where, "cli": cli_where},
         frames_per_s_in_turns=rates, frames_per_s_headless=headless,
         frames_per_s_viewer=viewer_rates,
         cli_stayed_alive="viewer still running" in out.getvalue(),
         cli_poses_finite=bool(np.isfinite(poses).all()), kernel_launches=launches,
         expected_launches=expected)
    for tag, got in launches.items():
        if got != expected:
            fail(f"{tag}: launches {got} != {expected}")
    for tag, n in (("solver", clouds["frames"]), ("cli", cli_clouds["frames"])):
        if n != N_FRAMES:
            fail(f"main_slam_viewer: {n} frames reached the {tag}'s viewer, not {N_FRAMES}")
    if len(cli_solver.viewer.server.scene.clouds) != N_FRAMES:
        fail("main_slam_viewer: the CLI's viewer sent "
             f"{len(cli_solver.viewer.server.scene.clouds)} clouds")
    if not traj_err <= VIEWER_POINT_REL_TOL * max(1.0, float(np.abs(c2w[:, :3, 3]).max())):
        fail(f"main_slam_viewer: frusta {traj_err} from solver.trajectory()")
    for tag, w in (("solver", solver_waits), ("cli", cli_waits)):
        if len(w) != VIEWER_CHUNKS or max(w) > VIEWER_WAITS_PER_CHUNK:
            fail(f"main_slam_viewer: the {tag}'s viewer waited {w} a chunk "
                 f"(limit {VIEWER_WAITS_PER_CHUNK})")
    if "viewer still running" not in out.getvalue() or poses.shape != (N_FRAMES, 16) \
            or not np.isfinite(poses).all():
        fail(f"main_slam_viewer: CLI poses {poses.shape} or it did not stay alive")


def phase_main_align_viewer(path_launches: dict) -> None:
    """46. main_align_viewer: ``cli/main_align --method irls`` at SMALL
    (chunk 15) without ``--headless`` through the stub: the first and last
    frame of each of the 3 chunks reach the viewer, each cloud equal to the
    host recomputation from that frame's fetched depth and global
    extrinsics; then ``keep_alive`` (ended through the module's
    ``time.sleep``)."""
    import types

    from da3slam_tpu_torch.cli import main_align
    from da3slam_tpu_torch.viz import viewer as viewer_mod

    def interrupt(_s):
        raise KeyboardInterrupt

    args = ["--image_dir", str(frames_dir()), "--model", "small", "--method", "irls",
            "--chunk_size", "15", "--overlap", "1"]
    saved_time = viewer_mod.time
    viewer_mod.time = types.SimpleNamespace(sleep=interrupt)
    interrupted = False
    try:
        with stub_viser() as servers, recorded_viewer_inputs() as (calls, _, _), \
                counted(path_launches, "main_align_viewer"), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            try:
                main_align.main(args)
            except KeyboardInterrupt:
                interrupted = True
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            clouds = check_viewer_clouds(calls)
    finally:
        viewer_mod.time = saved_time
    launches = path_launches["main_align_viewer"]
    expected = expected_launches(flash_attn_bound_fwd=EXPECTED_LAUNCHES)
    names = [c.name for c in servers[0].scene.clouds] if servers else []
    emit("main_align_viewer", args=args[2:], clouds=clouds, cloud_names=names,
         batches=[len(c[2][1]) for c in calls], kept_alive=interrupted, wall_s=wall,
         kernel_launches=launches, expected_launches=expected)
    if names != [f"/map/frame_{i}" for i in range(2 * VIEWER_CHUNKS)] or \
            [len(c[2][1]) for c in calls] != [2] * VIEWER_CHUNKS:
        fail(f"main_align_viewer: clouds {names}")
    if not interrupted:
        fail("main_align_viewer: the CLI did not keep the viewer alive")
    if launches != expected:
        fail(f"main_align_viewer: launches {launches} != {expected}")


def phase_main_video(path_launches: dict) -> None:
    """47. main_video: ``cli/main_video --crop 0.9 --brightness`` with the
    port's ``video_to_frames`` replaced by a writer of the 31 generated
    frames (the card has no video codec), ``--mode streaming --traj_formats
    tum`` (cli/streaming's chunks: 16, overlap 4) and ``--mode slam
    --headless`` (chunks of 15): the output files ``tests/test_cli.py``
    checks, finite poses, 12 bound-forward launches a chunk."""
    from PIL import Image

    import da3slam_tpu_torch.preprocess.host as host
    from da3slam_tpu_torch.cli import main_video

    frames = make_frames(N_FRAMES, seed=1)

    def write_frames(video_path, output_dir, stride=1, quality=95):
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for n, f in enumerate(frames[::stride]):
            Image.fromarray(f).save(out / f"{n:06d}.jpg", quality=quality)
        return len(frames[::stride])

    rows = {}
    saved = host.video_to_frames
    host.video_to_frames = write_frames
    try:
        for mode, extra in (("streaming", ["--traj_formats", "tum"]), ("slam", ["--headless"])):
            out = WORK / f"video_{mode}"
            with counted(path_launches, f"main_video_{mode}"), \
                    contextlib.redirect_stdout(io.StringIO()):
                t0 = time.perf_counter()
                ran = main_video.main(["--video", "clip.mp4", "--output_dir", str(out),
                                       "--crop", "0.9", "--brightness", "--mode", mode, *extra])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            files = ["frames/000000.jpg", "slam/camera_poses.txt"] + (
                ["slam/camera_poses_tum.txt", "slam/combined_pcd.ply"] if mode == "streaming"
                else [])
            missing = [f for f in files + ["cropped", "normalized"] if not (out / f).exists()]
            poses = np.loadtxt(out / "slam" / "camera_poses.txt", ndmin=2)
            n_chunks = len(ran.chunk_ranges) if mode == "streaming" else ran.chunk_count
            expected = expected_launches(flash_attn_bound_fwd=12 * n_chunks)
            launches = path_launches[f"main_video_{mode}"]
            rows[mode] = {"wall_s": wall, "frames_per_s": N_FRAMES / wall, "chunks": n_chunks,
                          "missing": missing, "poses_shape": list(poses.shape),
                          "poses_finite": bool(np.isfinite(poses).all()),
                          "kernel_launches": launches, "expected_launches": expected}
            if missing or poses.shape != (N_FRAMES, 16) or not np.isfinite(poses).all():
                fail(f"main_video {mode}: {rows[mode]}")
            if launches != expected or not n_chunks:
                fail(f"main_video {mode}: launches {launches} != {expected}")
    finally:
        host.video_to_frames = saved
    emit("main_video", frames=N_FRAMES, crop=0.9, brightness=True, runs=rows,
         wall_includes="building SMALL on the CPU, its upload, crop and brightness on the "
                       "card, JPEG decode and encode")


def _small_prediction(n: int):
    from da3slam_tpu_torch.models.da3 import DepthAnything3

    model = DepthAnything3.from_pretrained("small", device=torch.device("cuda"))
    paths = sorted(str(p) for p in frames_dir().iterdir())[:n]
    return model, paths


def phase_batch_viewer(path_launches: dict) -> None:
    """48. batch_viewer: ``show_prediction(mask_sky=True)`` over a SMALL
    prediction of 8 frames (kept on the card) through the stub: every frame
    in one batch, each cloud equal to the host recomputation, the kept
    points' confidences those of ``apply_sky_segmentation`` on the host."""
    from da3slam_tpu_torch.viz.batch_viewer import prediction_to_viewer_dict, show_prediction
    from da3slam_tpu_torch.viz.sky import apply_sky_segmentation

    model, paths = _small_prediction(CONF_CHUNK)
    with stub_viser() as servers, recorded_viewer_inputs() as (calls, _, _):
        with counted(path_launches, "batch_viewer"):
            pred = model.inference(image=paths, keep_on_device=True)
            t0 = time.perf_counter()
            viewer = show_prediction(pred, block=False, mask_sky=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        clouds = check_viewer_clouds(calls)
    scene = prediction_to_viewer_dict(pred)
    masked = apply_sky_segmentation(scene["conf"], scene["images"])
    s = viewer.point_stride
    conf_ok = all(np.array_equal(viewer.all_confs[i], masked[i][::s, ::s].reshape(-1)[
        _host_cloud(scene["depth"][i], scene["intrinsics"][i], scene["extrinsics"][i], s,
                    viewer.min_depth, viewer.max_depth)[1]]) for i in range(len(paths)))
    launches = path_launches["batch_viewer"]
    expected = expected_launches(flash_attn_bound_fwd=12)
    emit("batch_viewer", frames=len(paths), clouds=clouds, batches=len(calls),
         sky_share=float((masked == 0).mean()), show_s=wall,
         sent=len(servers[0].scene.clouds), confs_equal_host_mask=conf_ok,
         kernel_launches=launches, expected_launches=expected)
    if len(calls) != 1 or clouds["frames"] != len(paths) or not conf_ok:
        fail(f"batch_viewer: {len(calls)} batches, {clouds['frames']} frames, confs {conf_ok}")
    if launches != expected:
        fail(f"batch_viewer: launches {launches} != {expected}")


def phase_profile_trace(path_launches: dict) -> None:
    """49. profile_trace: a SMALL chunk of 15 frames under
    ``utils/profiling.py:profile_trace``: the Chrome trace is written and
    names the bf16 bound forward kernel (PROFILE_KERNEL), 12 launches; the
    spans ``model.inference`` and ``model.dpt`` sit in it, each with kernels
    whose launch the host issued inside it."""
    from da3slam_tpu_torch.utils.profiling import TRACE_FILE, profile_trace

    model, paths = _small_prediction(15)
    model.inference(image=paths, keep_on_device=True)  # warm
    trace_dir = WORK / "trace"
    with counted(path_launches, "profile_trace"):
        with profile_trace(trace_dir) as got:
            model.inference(image=paths, keep_on_device=True)
            torch.cuda.synchronize()
    path = trace_dir / TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"] if path.exists() else []
    kernels = [e for e in events if e.get("cat") == "kernel"]
    flash = [e for e in kernels if PROFILE_KERNEL in e.get("name", "")]
    launches = path_launches["profile_trace"]
    expected = expected_launches(flash_attn_bound_fwd=12)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    spans = {}  # the port's span -> kernels launched inside it
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in ("model.inference", "model.dpt"):
            spans[e["name"]] = sum(
                e["ts"] <= launch_ts.get(k.get("args", {}).get("correlation"), -1)
                <= e["ts"] + e["dur"] for k in kernels)
    emit("profile_trace", trace=str(path), yielded=str(got),
         trace_bytes=path.stat().st_size if path.exists() else 0, kernel_events=len(kernels),
         flash_events=len(flash), flash_ms=sum(e.get("dur", 0) for e in flash) / 1e3,
         kernel_launches=launches, expected_launches=expected, span_kernels=spans)
    if len(flash) != 12:
        fail(f"profile_trace: {len(flash)} {PROFILE_KERNEL} events in {path}, not 12")
    if set(spans) != {"model.inference", "model.dpt"} or not all(spans.values()):
        fail(f"profile_trace: the port's spans and their kernels: {spans}")
    if launches != expected:
        fail(f"profile_trace: launches {launches} != {expected}")


def phase_main_conf_figures(path_launches: dict) -> None:
    """50. main_conf_figures: ``cli/main_conf`` without ``--stats_only`` at
    SMALL over 8 frames.  Where matplotlib imports: the 8 comparison PNGs
    and the heatmap grid exist (12 launches).  Where it does not: the CLI
    stops before the model runs (0 launches) with an error naming
    matplotlib, and writes nothing."""
    from da3slam_tpu_torch.cli import main_conf

    try:
        import matplotlib  # noqa: F401
        case = "figures"
    except ImportError:
        case = "no_matplotlib"
    out_dir = WORK / "conf_viz"
    error = None
    with counted(path_launches, "main_conf_figures"), contextlib.redirect_stdout(io.StringIO()):
        try:
            main_conf.main(["--image_dir", str(frames_dir()), "--model", "small",
                            "--chunk_size", str(CONF_CHUNK), "--output_dir", str(out_dir)])
        except SystemExit as e:
            error = str(e)
    launches = path_launches["main_conf_figures"]
    pngs = sorted(p.name for p in out_dir.glob("*.png")) if out_dir.exists() else []
    want_pngs = [f"comparison_{i:03d}.png" for i in range(CONF_CHUNK)] + ["heatmap_grid.png"]
    expected = expected_launches(flash_attn_bound_fwd=12 if case == "figures" else 0)
    print(f"main_conf_figures: {case}", flush=True)
    emit("main_conf_figures", case=case, error=error, pngs=pngs, kernel_launches=launches,
         expected_launches=expected)
    if case == "figures" and (error is not None or pngs != want_pngs):
        fail(f"main_conf_figures: {error}, {pngs}")
    if case == "no_matplotlib" and (error is None or "matplotlib" not in error
                                    or out_dir.exists()):
        fail(f"main_conf_figures: without matplotlib the CLI gave {error!r} "
             f"(output written: {out_dir.exists()})")
    if launches != expected:
        fail(f"main_conf_figures: launches {launches} != {expected}")


def _voxel_reference(pts: np.ndarray, cols: np.ndarray, voxel: float):
    """``voxel_downsample``'s semantics in numpy with the C++ pass's own
    arithmetic: keys floor(x · (1 / f32 voxel)) in f64, f64 sums in point
    order, colours rounded by +0.5 and truncated.  (The package's numpy path
    divides in f32 instead, so a point within rounding of a voxel face may
    land in the neighbour: the JAX package's paths differ alike.)"""
    inv = 1.0 / np.float64(np.float32(voxel))
    keys = np.floor(pts.astype(np.float64) * inv).astype(np.int64)
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    out_pts = np.zeros((len(counts), 3), np.float64)
    np.add.at(out_pts, inverse, pts.astype(np.float64))
    out_cols = np.zeros((len(counts), 3), np.float64)
    np.add.at(out_cols, inverse, cols.astype(np.float64))
    return ((out_pts / counts[:, None]).astype(np.float32),
            (out_cols / counts[:, None] + 0.5).astype(np.uint8))


def _timed(fn) -> tuple[float, object]:
    t0 = time.perf_counter()
    out = fn()
    return time.perf_counter() - t0, out


# ICP at the benchmark cells' shapes: a 504² target map, the source strided
# by 4, 12 iterations, threshold 0.1 (slambench/workloads/*.json)
ICP_HW, ICP_STRIDE, ICP_KW = 504, 4, dict(threshold=0.1, max_iterations=12)
ICP_REPS = 50


def icp_overlap_inputs(i: int) -> tuple:
    """ICP's inputs as the alignment makes them for the overlap of frames
    ``i`` and ``i + 1`` of the synthetic corner room at ICP_HW², on the card:
    the source cloud strided by ICP_STRIDE, the target's full point map, K
    and both validity masks."""
    from da3slam_tpu_torch.core.geometry import backproject_depth
    from da3slam_tpu_torch.utils.synthetic import default_intrinsics, make_trajectory, render_depth

    hw = (ICP_HW, ICP_HW)
    K = default_intrinsics(hw)
    poses = make_trajectory(i + 2)
    prev, cur = (torch.from_numpy(render_depth(E, K, hw)).cuda() for E in poses[i:i + 2])
    Kt = torch.from_numpy(K).cuda()
    st = ICP_STRIDE
    src = backproject_depth(cur, Kt)[::st, ::st].reshape(-1, 3)
    return (src, backproject_depth(prev, Kt), Kt, cur[::st, ::st].reshape(-1) > 1e-6,
            prev > 1e-6)


def phase_icp_graph() -> None:
    """52. icp_graph: ``ops/icp.py:run_icp`` on CUDA inputs at the cells'
    shapes (ICP_HW, ICP_STRIDE, ICP_KW), with and without scale: the captured
    graph's transform, fitness and RMSE against the eager body on three
    overlaps, bit for bit, each read after all three replays; the capture's
    wall time; a replay's host µs (copies in, the launch, clones out) and its
    device ms (CUDA events), beside the eager body's; a replay under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host wait raises)."""
    from da3slam_tpu_torch.core.transforms import highest_precision
    from da3slam_tpu_torch.ops import icp

    cases = [icp_overlap_inputs(i) for i in (3, 10, 17)]
    saved = icp.GRAPHS
    rows = []
    try:
        for with_scale in (False, True):
            icp.GRAPHS = graphs = icp.ICPGraphs()
            kw = dict(ICP_KW, with_scale=with_scale)

            def eager(args):
                with highest_precision():
                    return icp._icp(*args, kw["threshold"], kw["max_iterations"], with_scale)

            def flat(res):
                return [*res.transform, res.fitness, res.inlier_rmse]

            refs = [flat(eager(args)) for args in cases]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first, mode = icp.run_icp(*cases[0], **kw)
            torch.cuda.synchronize()
            capture_ms = (time.perf_counter() - t0) * 1e3
            if mode != "capture":
                fail(f"icp_graph: the first call ran {mode!r}, not a capture")
            outs = [first] + [icp.run_icp(*args, **kw) for args in cases[1:]]
            modes = [mode] + [m for _, m in outs[1:]]
            outs = [flat(outs[0])] + [flat(r) for r, _ in outs[1:]]
            unequal = [[i, j] for i, (got, ref) in enumerate(zip(outs, refs))
                       for j, (a, b) in enumerate(zip(got, ref)) if not torch.equal(a, b)]
            if unequal or graphs.captures != 1 or modes != ["capture", "replay", "replay"]:
                fail(f"icp_graph (with_scale={with_scale}): unequal [case, output] {unequal}, "
                     f"{graphs.captures} captures, modes {modes}")

            def host_us(fn):
                fn()
                torch.cuda.synchronize()
                times = []
                for _ in range(ICP_REPS):
                    t0 = time.perf_counter()
                    fn()
                    times.append((time.perf_counter() - t0) * 1e6)
                    torch.cuda.synchronize()
                return float(np.median(times))

            replay = lambda: icp.run_icp(*cases[0], **kw)  # noqa: E731
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")  # a host wait in a replay raises
            try:
                replay()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            rows.append({
                "with_scale": with_scale, "bit_equal": True, "cases": len(cases),
                "points": int(cases[0][0].shape[0]), "capture_ms": capture_ms,
                "replay_host_us": host_us(replay), "replay_device_ms": cuda_ms(replay, ICP_REPS),
                "eager_host_us": host_us(lambda: eager(cases[0])),
                "eager_device_ms": cuda_ms(lambda: eager(cases[0]), ICP_REPS),
                "fitness": float(first.fitness)})
    finally:
        icp.GRAPHS = saved
    emit("icp_graph", hw=[ICP_HW, ICP_HW], stride=ICP_STRIDE, **ICP_KW, rows=rows)


def phase_native() -> None:
    """51. native: the port's C++ point-cloud library built with g++ (timed
    into a scratch path) and loaded; at LARGE main_align's fused-cloud size
    (NATIVE_POINTS random points) ``write_ply`` native against the numpy
    path (bytes equal, seconds) and ``read_ply`` likewise (arrays equal);
    ``voxel_downsample`` at 10^6 points against a numpy reference of its own
    arithmetic (``_voxel_reference``: count, centroids within
    NATIVE_VOXEL_TOL, colours equal; the voxels the package's numpy path
    assigns otherwise are counted); ``prediction_to_3dgs`` native against the numpy path on uint8
    images (count, records within NATIVE_GS_TOL, bytes equal or not)."""
    from types import SimpleNamespace

    import da3slam_tpu_torch.native as native
    from da3slam_tpu_torch.inout import export3d, ply

    scratch = WORK / "native"
    scratch.mkdir(parents=True, exist_ok=True)
    lib = scratch / "pointcloud_timed.so"
    build_s, _ = _timed(lambda: subprocess.run(native.build_command(lib), check=True,
                                               capture_output=True, text=True))
    available = native.is_available()
    if not available:
        fail("native: the point-cloud library did not build or load")

    @contextlib.contextmanager
    def numpy_path():
        saved = native._lib, native._load_failed
        native._lib, native._load_failed = None, True
        try:
            yield
        finally:
            native._lib, native._load_failed = saved

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(NATIVE_POINTS, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (NATIVE_POINTS, 3), dtype=np.uint8)
    times = {}
    times["write_native_s"], _ = _timed(lambda: ply.write_ply(scratch / "n.ply", pts, cols))
    with numpy_path():
        times["write_numpy_s"], _ = _timed(lambda: ply.write_ply(scratch / "p.ply", pts, cols))
    bytes_equal = (scratch / "n.ply").read_bytes() == (scratch / "p.ply").read_bytes()
    times["read_native_s"], (rp, rc) = _timed(lambda: ply.read_ply(scratch / "p.ply"))
    with numpy_path():
        times["read_numpy_s"], (qp, qc) = _timed(lambda: ply.read_ply(scratch / "n.ply"))
    read_equal = (np.array_equal(rp, pts) and np.array_equal(rc, cols)
                  and np.array_equal(qp, pts) and np.array_equal(qc, cols))
    for f in ("n.ply", "p.ply"):
        (scratch / f).unlink()

    vp = rng.uniform(-1, 1, (NATIVE_VOXEL_POINTS, 3)).astype(np.float32)
    vc = rng.integers(0, 256, (NATIVE_VOXEL_POINTS, 3), dtype=np.uint8)
    times["voxel_native_s"], (a_pts, a_cols) = _timed(
        lambda: native.voxel_downsample(vp, vc, NATIVE_VOXEL))
    with numpy_path():
        times["voxel_numpy_s"], (b_pts, b_cols) = _timed(
            lambda: native.voxel_downsample(vp, vc, NATIVE_VOXEL))
    r_pts, r_cols = _voxel_reference(vp, vc, NATIVE_VOXEL)

    def by_voxel(x):
        # each centroid lies in its voxel; two centroids' coordinates may tie
        # to rounding, so the floats themselves do not sort alike
        return x[np.lexsort(np.floor(x / NATIVE_VOXEL).astype(np.int64).T)]

    same = a_pts.shape == r_pts.shape
    voxel_err = float(np.abs(by_voxel(a_pts) - by_voxel(r_pts)).max()) if same else float("inf")
    colors_equal = same and np.array_equal(
        a_cols[np.lexsort(np.floor(a_pts / NATIVE_VOXEL).astype(np.int64).T)],
        r_cols[np.lexsort(np.floor(r_pts / NATIVE_VOXEL).astype(np.int64).T)])
    numpy_moved = (int(np.sum(np.abs(by_voxel(a_pts) - by_voxel(b_pts)).max(-1) > 1e-4))
                   if a_pts.shape == b_pts.shape else None)

    N, H, W = 3, 64, 72
    depth = rng.uniform(0.5, 3.0, (N, H, W)).astype(np.float32)
    depth[0, 5, 5] = 0.0
    K = np.zeros((N, 3, 3), np.float32)
    K[:, 0, 0] = K[:, 1, 1] = 50.0
    K[:, 0, 2], K[:, 1, 2], K[:, 2, 2] = W / 2, H / 2, 1.0
    E = np.tile(np.eye(4, dtype=np.float32)[:3], (N, 1, 1))
    E[1, :3, 3] = [0.3, -0.1, 0.2]
    pred = SimpleNamespace(depth=depth, conf=rng.uniform(0.5, 2, (N, H, W)).astype(np.float32),
                           intrinsics=K, extrinsics=E,
                           processed_images=rng.integers(0, 256, (N, H, W, 3), dtype=np.uint8))
    n_native = export3d.prediction_to_3dgs(pred, scratch / "gs_n.ply")
    with numpy_path():
        n_numpy = export3d.prediction_to_3dgs(pred, scratch / "gs_p.ply")
    a, b = export3d.read_3dgs_ply(scratch / "gs_n.ply"), export3d.read_3dgs_ply(scratch / "gs_p.ply")
    gs_err = max(float(np.abs(a[k] - b[k]).max()) for k in a) if n_native == n_numpy else None
    gs_bytes_equal = (scratch / "gs_n.ply").read_bytes() == (scratch / "gs_p.ply").read_bytes()
    emit("native", library=str(native.library_path().relative_to(ROOT)), available=available,
         build_s=build_s, points=NATIVE_POINTS, ply_bytes=15 * NATIVE_POINTS, **times,
         write_bytes_equal=bytes_equal, read_arrays_equal=read_equal,
         voxel_points=NATIVE_VOXEL_POINTS, voxel=NATIVE_VOXEL,
         voxels_native_reference_numpy_path=[int(len(a_pts)), int(len(r_pts)), int(len(b_pts))],
         voxel_max_abs_err=voxel_err, voxel_colors_equal=bool(colors_equal),
         numpy_path_voxels_moved=numpy_moved,
         gs_splats=[n_native, n_numpy], gs_max_abs_err=gs_err, gs_tol=NATIVE_GS_TOL,
         gs_bytes_equal=gs_bytes_equal)
    if not (bytes_equal and read_equal):
        fail(f"native: PLY bytes equal {bytes_equal}, read arrays equal {read_equal}")
    if not (voxel_err <= NATIVE_VOXEL_TOL and colors_equal):
        fail(f"native: voxel_downsample {len(a_pts)} voxels against the reference's "
             f"{len(r_pts)}, centroids {voxel_err} apart, colours equal {colors_equal}")
    if gs_err is None or not gs_err <= NATIVE_GS_TOL:
        fail(f"native: 3DGS splats {n_native} against {n_numpy}, records {gs_err} apart")


SOURCES = {
    "flash_attn_bound_fwd": ("da3slam_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                             "da3slam_tpu/ops/flash_attention.py:116", "cross"),
    "flash_attn_stable_fwd": ("da3slam_tpu_torch/ops/csrc/flash_attn_fwd.cu",
                              "da3slam_tpu/ops/flash_attention.py:41", "cross"),
    "flash_attn_bwd_dq": ("da3slam_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                          "da3slam_tpu/ops/flash_attention.py:298", "train_cross_bf16"),
    "flash_attn_bwd_dkv": ("da3slam_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                           "da3slam_tpu/ops/flash_attention.py:340", "train_cross_bf16"),
    "conv3x3": ("da3slam_tpu_torch/ops/csrc/conv3x3.cu",
                "da3slam_tpu/ops/conv3x3.py:74", "head1-large"),
    # the probes' headline is the first row at the tools' shape (variant A, old)
    "flash_probe_nomax": ("da3slam_tpu_torch/ops/csrc/flash_probe_fwd.cu",
                          "tools/flash_nomax_probe.py:31", "tool"),
    "flash_probe_bisect": ("da3slam_tpu_torch/ops/csrc/flash_probe_fwd.cu",
                           "tools/flash_bound_bisect.py:35", "tool"),
    "flash_probe_lab": ("da3slam_tpu_torch/ops/csrc/flash_probe_fwd.cu",
                        "tools/flash_lab.py:34", "tool"),
    "int8_flash_fwd": ("da3slam_tpu_torch/ops/csrc/int8_flash_fwd.cu",
                       "tools/int8_flash_probe.py:51", "tool"),
}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script runs only on a CUDA GPU")
    phase_env()
    phase_build()
    rows = phase_forwards()
    rows.update(phase_backward())
    phase_model_parity()
    phase_train_grad_parity()
    phase_train_grad_parity(torch.bfloat16)
    path_launches: dict = {}
    f32_losses = phase_train(path_launches)
    phase_train_bf16(path_launches, f32_losses)
    phase_public_flash_attention(path_launches)
    phase_main_path(path_launches)
    rows.update(phase_conv3x3())
    rows.update(phase_flash_probes())
    rows.update(phase_int8_flash())
    phase_tools(path_launches)
    phase_main_align(path_launches)
    phase_w8a8(path_launches)
    slam_runs = phase_main_slam_irls(path_launches)
    phase_checkpoint()
    phase_pipeline(path_launches, slam_runs)
    phase_loop_closure()
    phase_main_slam_loop(path_launches)
    phase_streaming(path_launches)
    phase_streaming_mesh_room()
    mesh_frames = phase_preprocess(path_launches)
    phase_tsdf(path_launches)
    phase_main_mesh(path_launches, mesh_frames)
    phase_rasterize(path_launches)
    trained = phase_main_3dgs(path_launches, mesh_frames)
    phase_render(path_launches, trained)
    ckpt, nested = phase_nested_checkpoint()
    nested_out = phase_main_slam_nested(path_launches, ckpt, nested)
    del nested
    torch.cuda.empty_cache()
    phase_parity_cli(*phase_nested_parity())
    phase_main_conf(path_launches)
    phase_evaluate(nested_out)
    phase_main_slam_viewer(path_launches)
    phase_main_align_viewer(path_launches)
    phase_main_video(path_launches)
    phase_batch_viewer(path_launches)
    phase_profile_trace(path_launches)
    phase_main_conf_figures(path_launches)
    phase_native()
    phase_icp_graph()
    small_ref = phase_mesh(path_launches)
    phase_mesh_nccl(path_launches, small_ref)
    phase_mesh_pp_giant(path_launches)
    phase_train_mesh(path_launches)
    kernels = []
    for name, (source, replaces, headline) in SOURCES.items():
        by_path = {path: counts[name] for path, counts in path_launches.items()}
        head = next(r for r in rows[name] if r["case"] == headline)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "headline_case": headline, "shapes": rows[name],
        })
        if not sum(by_path.values()):
            fail(f"{name} was launched no time on the driven paths")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
