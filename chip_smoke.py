#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's HiFi-GAN serving and training paths, and the
training recipe from wav files on disk, the DSP layer with the VoiceBank
enhancement recipe, feature extraction from a wav tree, the text-to-speech
recipe with synthesis and its decode, the separation and transcription
recipes, the multi-GPU layer's data-parallel step, the serving path's bf16
fast modes, the critics' fast modes (K6 in 'default' and on bf16 tensors,
the folded MSD), and the generator's modes with the recipe in the JAX
recipe's precision, once on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. device: requires CUDA, prints the card's name and power limit, turns TF32
   off so that the plain versions run in full fp32;
2. build: compiles the CUDA kernels from ``pytorch_sound_tpu_torch/csrc``;
3. the log-mel kernel (K2, an in-block fp64 FFT) vs its plain version on
   the card (both conventions), short inputs (t = 640 and t = pad + 1),
   every bin (fmax None), n_fft 512 and 2048, inputs the reflect pad exceeds
   (t = 1 ... 385, numpy's reflect rule: JAX's shapes, (3, 80, 0) below one
   frame with no launch, K4's backward at 255 / 384 / 385, reruns
   bit-identical), the 16 x 2 s shape that phase 6 times, and a batch's
   log-mel against its items' bit for bit;
4. the generator-stage kernel vs its plain version, each of HiFi-GAN v2's four
   stages with the bundled checkpoint's weights, fed by the real conv_pre and
   earlier stages;
5. the main path, ``InterfaceHifiGAN('hifi_gan_v2', device='cuda')``: every
   encode against the plain version run in fp64 on the same card tensor,
   decode, cycle consistency, the bench-shape decode, card vs CPU decode,
   streaming decode, and the launch counts of both kernels; then new
   weights written through
   ``.data`` (their version counters unchanged): the next decode follows
   them, and writing the old ones back restores the first decode bit for
   bit;
6. timings (CUDA events) of kernel vs plain, labelled with the card, K2
   also beside ``torch.stft`` alone and the recorded times of the direct-DFT
   kernel it replaced, and what splitting a decode's weights into TF32
   fragments costs, per weight in torch ops and in the entry points' split
   kernel (its device time by ``torch.profiler``);
7. the training path, ``HiFiGANTrainer(...).run()`` at full width (HiFi-GAN
   v2 with weight norm, MPD base, MSD base, 16 x 8192-sample segments): K4
   (the trainable log-mel: K2 forward, its own backward kernels) vs its
   plain version and fp64 autograd, six steps with checkpoints, a resume
   from step 3 that replays steps 4-6, one step on the card against the same
   step on the CPU, the log-mel launch counts of the run (K4's backward once
   per training step), and timings;
8. the K6 training route, every critic conv and generator upsample on the
   grouped-conv kernels: each kernel (forward, dx, dw) against its plain
   version on every conv of MPD base and MSD base at the critic phase's
   32 x 8192 inputs and at v2's four upsamples, one line per layer with its
   times (kernel / plain / cuDNN) and the kernel each entry point's rows per
   group route to (tensor cores or CUDA cores), then the sums beside the
   fp32 and 3xTF32 bounds and the layers each entry loses to cuDNN;
   ``HiFiGANTrainer(...).run()`` at full
   width for 3 steps and a validation batch with the launch counts the
   models' routes give; card vs CPU and kernel route vs cuDNN route, one
   step each; the kernel route's step time beside phase 7's;
9. HiFi-GAN v1 serving on weights from a seed (``init_params`` with a
   ``torch.Generator`` seeded 0, folded): the generator-stage kernel against
   its plain version on each of v1's four stages (the 256- and 128-channel
   stages in the kernel's cluster layout, conv_pre folded into stage 0) and
   the resblock-stage kernel (K3) on each stage's resblock input, at 2 x 61
   and 16 x 256 frames; the main path ``InterfaceHifiGAN('hifi_gan_v1',
   params=..., device='cuda')``: encode, the 16 x 256 decode, card vs CPU,
   the ``full_stage=False`` route (K3) against the full-stage decode,
   streaming, the launch counts; timings, the TF32 split's cost beside the
   decode;
10. the flash-attention kernels (K5: forward, dK / dV, dQ) against their plain
   versions at 4 x 8 heads x 2048 / 4096 x 64, a ragged T = 4001 with a key
   mask, D = 160, masks with whole masked tiles inside an item, leading
   masked tiles (the forward's first live tile wipes nothing), an item with
   every key masked and mask edges inside a tile (the kernels' tile skip;
   masked keys' dK / dV exactly 0), K5a's forward without the logsumexp,
   D = 128, and at T = 16384 (forward
   against the plain scan, gradients on one (n, h) slice); the main path,
   ``MultiHeadAttention(512, 8)`` at 4 x 4096 with a key mask on its auto
   route (the kernels), forward and backward against the dense route and
   the forward against the CPU, the launch counts; timings of the kernels,
   their plain versions and ``scaled_dot_product_attention`` at T = 2048 /
   4096 / 16384, and of the module's forward + backward on both routes at
   T = 256 ... 4096;
11. the recipe from disk (``examples.hifi_gan.main``): a VCTK tree under
   ``$TMPDIR`` (4 speakers x 24 utterances of 2.05-4 s, int16, ~13 MB),
   ``VCTKMeta.make_meta`` (88 train and 8 validation rows), the train loader
   alone at 0 and 2 worker threads, ``main('vctk', ...)`` on the K6 route for
   6 steps with exact K2 / K4 / K6 launch counts, 3 steps and a resume to 6
   whose step-6 checkpoint equals the first run's bit for bit, 2 steps on
   the default (cuDNN) route, and ``python -m
   pytorch_sound_tpu_torch.examples.hifi_gan vctk ...`` once as a command;
   the loader's ms per batch beside the recipe's and phase 8's step times;
12. the DSP layer and the VoiceBank enhancement recipe: the log-mel kernel
   on its mixed-radix FFT at the n_fft that are not powers of two
   (``FFT_GEOMETRIES``: 400 / 100 at 16 kHz, 1000 / 250, 128 / 32, 8192 /
   2048, 300 / 100, odd 375 / 125) and on its direct DFT where the FFT size
   has a prime factor above 7 (``DIRECT_GEOMETRIES``: 802 / 401, 1102 /
   551), both conventions against the plain version in fp64, reruns
   bit-identical, each launch counted on the path it must take; K4's
   backward at 400 / 100 and at 802 / 401; the transforms' main path
   (``LogMelSpectrogram`` on (N, T) and (N, 1, T), ``MFCC``,
   ``LogMelSpectrogram`` at 16 kHz, 400 / 100) with exact launch counts,
   none of them on the direct DFT; timings at 16 x 4 s of K2 and K4's
   backward at 400 / 100 on the FFT and, in the same run, on the direct DFT
   (``logmel._direct_log_mel`` / ``_direct_backward``); then a VoiceBank
   tree under ``$TMPDIR`` (56 pairs, int16), its metas, the loader alone,
   ``examples.voice_bank.main`` with
   ``spec_masker_base`` at 8 x 32768 for 6 steps and 3 steps plus a resume
   to 6 (step-6 checkpoints equal bit for bit; the trainer's default
   device prefetch of 2 batches, as in phase 11), the from-disk step time
   at prefetch 0 and 2 with 0 and 2 loader threads, one step on the card
   against the CPU, the in-memory step time; ``enhance`` at 8 x 32768
   against the CPU, its identity-mask round trip and time,
   ``multi_stft_loss`` and the PQMF round trip against the CPU;
13. feature extraction (``scripts.preprocess.Processor.extract_features``):
   a VCTK-shaped tree under ``$TMPDIR`` (4 speakers x 48 speech-like int16
   utterances of 1.5-9 s at 48 kHz, 16 white-noise files at 44.1 kHz, 16
   at 22.05 kHz, 2 stereo files, 1 with no data; ~110 MB); the native
   runtime built with g++ from ``csrc/tpusound.cc`` and its int16 loader
   against the WAV reader on every file; ``resample_poly`` on the card at
   48 / 44.1 -> 22.05 kHz against the native resampler and the CPU, with
   TF32 off and on; the pipeline at the JAX defaults (batch 16, bf16 wire,
   stages 2) within one bf16 ulp of its CPU run, at batch 64 on the f32
   wire at stages 2 and 3 within 1e-4, and on the host-resampled wires at
   int8 at the JAX test's gates, each with K2 launched once per batch;
   every 48 kHz batch's K2 output against K2's plain version on that
   batch's card tensors; utterances per second and per-batch decode /
   staging / H2D / program / D2H / save times, the card's busy share;
14. the text-to-speech family: an LJSpeech-shaped tree under ``$TMPDIR``
   (100 speech-like int16 utterances of 2.1-9 s, English sentences), the
   port's ``Processor.ljspeech``, ``examples.ljspeech_tts.main`` with
   ``transformer_tts_base`` at batch 16 for 4 steps and a validation batch
   (K2 once per batch, counted); on a fixed 16 x 131072 batch from the tree,
   K2's targets against the plain log-mel in fp64, one step card vs CPU
   (losses and per-parameter gradients), three steps with ``remat=True``
   against three without, the step time, and in a fresh process the
   trainer's profiler window (its trace, the card's busy share);
   ``synthesize`` at 4 x 400 with no stop (399 frames) against
   ``decode_mel``'s teacher-forced columns on the card and on the CPU,
   frames per second;
   the v2 decode of that mel (K1's four launches, each stage against its
   plain version, card vs CPU); Griffin-Lim (32 iterations, zero phase)
   float64 card vs CPU, fp32 timed; the STFT on inputs shorter than one
   frame through cuFFT (JAX's empty shapes);
15. separation and transcription: K2 at the Maestro recipe's geometry (44.1
   kHz, 1024 / 256, 80 mels to sr / 2) on 4 x 131072 samples against the
   plain log-mel in fp64, timed; a DSD100 chunk tree under ``$TMPDIR``,
   ``examples.dsd100.main`` with ``spec_unet_base`` at 4 x 65536 for 3
   steps and a validation batch, one step card vs CPU, ``separate`` at 4 x
   65536 card vs CPU (voice + background rebuild the mixture), the step
   and ``separate`` times; a Maestro tree (12 performances of 4 s with MIDI
   files, the released records .json), ``examples.maestro.main`` with
   ``frame_pitch_base`` at 4 x 131072 for 3 steps and a validation batch
   (K2 once a batch: 4 launches, counted), one step card vs CPU, the step
   time; for both recipes two steps under the trainer's profiler window in
   one process of their own (the card's busy share, device ms a step, the
   kernels with the most device time);
16. the multi-GPU layer on the one card (``parallel``, ``Trainer(mesh=...)``):
   (a) one NCCL rank in this process over a file store under ``$TMPDIR``,
   three full-width split steps of ``HiFiGANTrainer(..., mesh=make_mesh())``
   on the K6 route against the same three steps with no mesh, from the same
   weights and batches: every parameter and both optimizers' states
   bit-identical, the K2 / K4 / K6 launches of the mesh run as
   ``expected_gc_launches`` derives them, the step time with and without
   the gradient reduction; ring attention at world 1 against dense
   attention; ``examples.voice_bank.main(use_mesh=True)`` under torchrun's
   environment of one process on phase 12's tree, 2 steps; (b) two gloo
   ranks sharing the card (``spawn_ranks``), 8 rows each of the same
   16 x 8192 global batches for 2 steps: the losses, the second step's
   reduced gradients and the parameters' change over the two steps against
   (a)'s single-process steps, both ranks' parameters bit-identical; (c)
   ``dryrun_multigpu(1, 'cuda')`` in a process of its own. NCCL across two
   cards is not checked here: the machine has one;
17. the serving fast modes (``precision='bf16x3'`` / ``'default'``, the bf16
   tensor cores): K1 in both modes and K3 in 'default' against the plain
   version of the mode on the same card tensor, on v2's four stages (the
   bundled weights, fed as phase 4 feeds them) and v1's four seeded stages
   (the cluster layout, conv_pre folded), at 4 / 2 x 61 and the bench
   shapes, within ``MODE_TOL``; the main paths with the counters from zero:
   ``InterfaceHifiGAN('hifi_gan_v2', precision=...)`` on bench.py's 32 x 256
   mel (``default_rng(7)``, randn * 2 - 4), a card slice, ``decode_streaming``
   in 'bf16x3' and its whole decode, v1's interfaces on the 16 x 256 bench
   mel, ``dtype='bfloat16'`` (cuDNN's bf16 convs, no K1 launch) and K3
   'default' through ``resblock_stage``: exact launch counts per mode, none
   at 'highest'; each fast decode's max / mean abs error and SNR against
   'highest' (``vocoder_bf16x3_waveform_max_err`` ...), card vs CPU per
   mode, the streaming interior against the whole decode; timings of each
   mode's v2 32 x 256 and v1 16 x 256 decode and stages beside 'highest',
   the plain versions and the bf16 dtype path, with each stage's share of
   its bf16 tensor-core bound;
18. the critics' fast modes: each grouped-conv entry point (forward, dx,
   dw) in precision 'default' on float32 tensors and on bfloat16 tensors
   against the plain version of the mode (the fp32 conv of the bf16-rounded
   operands) on every conv of MPD base and MSD base at phase 8's 32 x 8192
   inputs and on the folded MSD's 8 convs, within GC_FWD_TOL / GC_GRAD_TOL
   (plus one bf16 ulp on bf16 tensors) and nearer it than the plain
   'highest' by RMS (MODE_RMS_RATIO), one line per layer with the times of
   the kernel, the plain version, the kernel on bf16 tensors and its plain
   version, K6 'highest' and cuDNN's bf16 call, then the sums beside the
   bf16 bound; ``msd_apply_folded`` against the unfolded MSD on the cuDNN
   and the K6 route in fp32 (outputs within 2e-5, gradients within 5e-4 /
   5e-5); ``HiFiGANTrainer(...).run()`` at full width for 3 steps and a
   validation batch with the critics in 'default' on the K6 route, then
   also with ``msd_folded=True``, then with bf16 activations
   (``compute_dtype='bf16'``): exact launch counts per route
   (``launches_by_mode``: the upsamples at 'highest', the critics in their
   mode; the folded MSD 8 convs a pass instead of 24), one step card vs CPU
   (MODE_STEP_RTOL, MODE_STEP_GRAD_TOL), and the step time and peak memory
   of each in turns with the critics at 'highest'. Each critic conv also
   runs the cuDNN route in 'default' (``hifi_gan.rounded_conv``: cuDNN's
   fp32 conv of the bf16-rounded operands, its backward rounding the
   cotangent, cuDNN's TF32 off) against the same plain version;
19. the generator's modes: every conv of v2's generator at 16 x 8192 on its
   real inputs and v1's distinct resblock geometries (C 256 / 128, k 3 / 7 /
   11, dilations 1 / 3 / 5): K6 in 'default' and the cuDNN route in
   'default' against the plain version of the mode at
   GC_FWD_TOL / GC_GRAD_TOL and MODE_RMS_RATIO, per-layer times of K6 and
   cuDNN in both modes; ``WNConv2d`` in 'default'; the generator's forward
   + backward per route and mode with K6's launches per mode; the recipe in
   JAX's modes (``Generator(precision='default')``, the critics in
   'default', K2 / K4 in 'bf16x3') on the K6 route (every generator and
   critic conv) and on cuDNN for 3 steps and a validation batch: exact K6
   and K2 / K4 counts per mode, one step card vs CPU (the losses and the
   critics' gradients at MODE_STEP_RTOL / MODE_STEP_GRAD_TOL, the
   generator's worst and median at GEN_MODE_GRAD_TOL / GEN_MODE_GRAD_MEDIAN_TOL,
   which a card generator left at 'highest' must exceed) beside the same
   step on the card's two routes, the step times in turns with 'highest'; K4 in each mode at 16 x
   8192 against fp64.

The line before the last is a JSON object with one entry per kernel, each
with its time, its plain version's, the least time the card could take for
the same work (``bound_ms``, from the shapes, at the H100's published peaks;
for K2's direct path, ``logmel_direct``, timed at 400 / 100 through
``_direct_log_mel``, and K4's backward there an FFT's operations as for the
FFT path, the direct DFT's beside them as ``dft_bound_ms`` and
``direct_bwd_dft_bound_ms``;
for K6's 'default' and bf16 entries every product at the bf16 tensor-core
peak and the bytes at the tensors' dtype, their ``ms`` the sums over the
critics' convs, ``highest_ms`` K6 'highest' and ``folded_ms`` the folded
MSD's convs in the same run, ``library_ms`` the cuDNN route's 'default'
(the same function) on float32 tensors and cuDNN's bf16 calls on bf16 ones;
for K6 on the generator in 'default' the sums over v2's 78 convs, its
``launches`` those of phase 19's K6-route recipe run (generator and
critics);
for K5 from the valid keys only, the count of the keys each kernel processes
beside it as ``implemented_bound_ms``, and for the kernels that run 3xTF32
on the tensor cores, K5's three and K6's dw, the same FLOPs three times at
the TF32 peak as ``tc_bound_ms``) and the time of one PyTorch call computing
the same function where there is one (``library_ms``: cuDNN's convolution
and its backward for K6, ``scaled_dot_product_attention`` in fp32 for K5,
whose one backward call computes dq, dk and dv and stands beside both
backward kernels, ``library_scope`` 'dq+dk+dv'; none exists for the
others). The last line is
``{"ok": true, "device": {...}}``.
"""

import gc as garbage
import itertools
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SR = 22050
UP = 256                          # waveform samples per mel frame (v2)
MEL_TOL = 1e-4                    # log-mel kernel vs plain (tests/test_pallas.py:98)
STAGE_TOL = 2e-5                  # one stage vs plain (tests/test_pallas.py:187)
DECODE_TOL = 2e-4                 # card decode vs CPU decode (tests/test_pallas.py:151)
STREAM_TOL = 1e-5                 # streaming interior vs whole decode
GRAD_TOL = 1e-4                   # K4 gradient vs plain (tests/test_pallas.py:305)
SHORT_T = (1, 2, 255, 256, 383, 384, 385)   # lengths the reflect pad exceeds
GC_FWD_TOL = 1e-5                 # K6 forward: max abs error / the plain version's max abs
GC_GRAD_TOL = 1e-4                # K6 dx and dw, the same ratio (dw sums up to 262,144 terms)
RESUME_RTOL = 1e-5                # resumed run's logged losses vs the first run's
CARD_CPU_RTOL = 1e-4              # one training step's losses, card vs CPU
CARD_CPU_GRAD_TOL = 1e-3          # ||g_card - g_cpu|| / ||g_cpu|| per parameter
FLASH_FWD_TOL = 1e-5              # K5 forward (o, lse): max abs error / the plain version's max abs
FLASH_GRAD_TOL = 1e-4             # K5 dq, dk, dv, the same ratio (tests/test_attention.py:237)
MHA_T = 4096                      # the blockwise MHA's frames: JAX's auto_threshold
MHA_TOL = 1e-4                    # MHA kernel route vs dense route / CPU, ratio to max abs
MHA_GRAD_TOL = 1e-4               # ||g_kernel - g_dense|| / ||g_dense|| per parameter and input
SEG = 8192                        # training segment (examples/hifi_gan.py:348)
BATCH = 16
LOSSES = ('loss', 'disc_loss', 'adv', 'feature_matching', 'mel_l1')
# K2 / K4 as the direct-DFT kernel and the autograd backward ran them on PR 9's
# tree (PERF.md section 6, NVIDIA H100 80GB HBM3 at 700 W): reference only
PR9_MS = {'k2_encode_16x2s': 0.547, 'k2_plain_encode_16x2s': 0.248,
          'k4_fwd_16x8192': 0.286, 'k4_bwd_16x8192': 1.300,
          'k4_plain_fwd_16x8192': 0.398, 'k4_plain_bwd_16x8192': 0.901}

# H100 SXM published peaks (NVIDIA data sheet, 700 W): fp32 outside the
# tensor cores, fp64 on the tensor cores (the faster fp64 route), HBM3
PEAK_FP32 = 67e12
PEAK_FP64 = 67e12
PEAK_FP64_CUDA_CORES = 34e12      # fp64 outside the tensor cores: K2's FFT
PEAK_TF32 = 495e12                # dense TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12


def log(phase, **fields):
    print('%-8s %s' % (phase, ' '.join('%s=%s' % kv for kv in fields.items())), flush=True)


def tones(rng, n, samples, am=True):
    """n harmonic tones (f0 110..300 Hz), amplitude-modulated, light noise."""
    t = np.arange(samples) / SR
    f0 = rng.uniform(110.0, 300.0, size=(n, 1))
    wav = sum(0.4 / h * np.sin(2 * np.pi * h * f0 * t) for h in (1, 2, 3))
    if am:
        wav = wav * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))
    wav = wav + 0.003 * rng.standard_normal((n, samples))
    return (0.6 * wav / np.abs(wav).max(axis=1, keepdims=True)).astype(np.float32)


def am_tones(f0s, samples):
    """The cycle-consistency signal of tests/test_vocoder.py:141-160: 0.4 sin
    at f0, amplitude-modulated at 3 Hz, one row per f0."""
    t = np.arange(samples) / SR
    f0 = np.asarray(f0s, dtype=np.float64)[:, None]
    return (0.4 * np.sin(2 * np.pi * f0 * t)
            * (1 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)


def max_err(a, b):
    return float((a - b).abs().max())


def cuda_ms(fn, iters):
    """Mean milliseconds per call of ``fn`` over ``iters`` calls, after warm-up."""
    import torch
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(plain, kernel, iters):
    """Plain, kernel, kernel, plain on one card; mean of each side."""
    p1 = cuda_ms(plain, iters)
    k1 = cuda_ms(kernel, iters)
    k2 = cuda_ms(kernel, iters)
    p2 = cuda_ms(plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2, (k1, k2), (p1, p2)


def bound(fp32_flops, fp64_flops, nbytes, fp64_peak=PEAK_FP64):
    """(ms, 'operations' or 'bytes'): the larger of the operations over the
    card's peak rates for their type and the bytes over its memory rate."""
    ops_s = fp32_flops / PEAK_FP32 + fp64_flops / fp64_peak
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, 'operations' if ops_s >= bytes_s else 'bytes'


def split_ms(gen, decode, iters=5):
    """What splitting a decode's stage weights into TF32 fragments costs:
    (each weight split in torch ops by ``tf32_fragments``, ms per decode by
    CUDA events, host launch gaps included: the per-call alternative to the
    kernel; the device time per decode of the entry points' own split,
    ``tf32_split_kernel``, and of the whole decode, by ``torch.profiler``
    over ``iters`` calls of ``decode``)."""
    import torch
    from torch.profiler import ProfilerActivity
    from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs
    stages = [gen.stage_args(i) for i in range(len(gen.upsample_rates))]

    def per_weight():
        for a in stages:
            gs.tf32_fragments(a['up_weight'].transpose(0, 1))
            for block in a['blocks']:
                for w, _, _ in block:
                    gs.tf32_fragments(w)

    torch_ms = cuda_ms(per_weight, 20)
    decode()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            decode()
        torch.cuda.synchronize()
    split = total = 0.0
    for e in prof.key_averages():
        t = getattr(e, 'device_time_total', 0.0)
        total += t
        if 'tf32_split_kernel' in e.key:
            split += t
    assert split > 0, 'the profiler saw no tf32_split_kernel'
    return torch_ms, split / iters / 1e3, total / iters / 1e3


def stage_work(x, args):
    """(fp32 FLOPs, bytes) of one fused generator stage on input x: the
    folded conv_pre (per input position), the transposed conv, every resblock
    conv and conv_post at their algorithmic MACs per output position; x, the
    weights and the output moved once."""
    n, _, t_in = x.shape
    u, w_up = args['upsample_rate'], args['up_weight']
    c_in, c = w_up.shape[:2]
    positions = n * t_in * u
    macs = c_in * c * w_up.shape[2] // u
    weights = w_up.numel() + args['up_bias'].numel()
    pre_macs = 0
    if args.get('conv_pre') is not None:
        w, b = args['conv_pre']
        pre_macs = w.numel() * n * t_in
        weights += w.numel() + b.numel()
    for block in args['blocks']:
        for w, b, _ in block:
            macs += w.shape[0] * w.shape[1] * w.shape[2]
            weights += w.numel() + b.numel()
    c_out = c
    if args['conv_post'] is not None:
        w, b = args['conv_post']
        macs += w.shape[1] * w.shape[2]
        weights += w.numel() + b.numel()
        c_out = 1
    return (2.0 * (macs * positions + pre_macs),
            4.0 * (x.numel() + weights + n * c_out * t_in * u))


def mma_rate_tflops(dev):
    """TF32 mma.sync m16n8k8 TFLOP/s on this card when nothing else runs
    (csrc/mma_rate.cu, one 384-thread block per SM): the ceiling of the
    3xTF32 kernels, which issue mma.sync."""
    import torch
    from pytorch_sound_tpu_torch.ops.cuda import _build
    blocks, threads, iters = torch.cuda.get_device_properties(dev).multi_processor_count, 384, 4096
    out = torch.empty(blocks * threads, device=dev)

    def run(n):
        _build.check(_build.library().mma_rate(out.data_ptr(), blocks, threads, n,
                                               torch.cuda.current_stream().cuda_stream),
                     'mma_rate')
    ms = cuda_ms(lambda: run(iters), 3)
    return blocks * threads // 32 * 8 * iters * 2048 / ms / 1e9


def resblock_flops(n, t, blocks):
    """FLOPs of a stage's resblock convs over n x t positions: the part of a
    stage the stage kernel runs as 3xTF32 on the tensor cores."""
    return 2.0 * n * t * sum(w.numel() for block in blocks for w, _, _ in block)


def tc_bound(flops, tc_flops, nbytes):
    """ms: the bound of a stage-kernel call whose ``tc_flops`` run as 3xTF32
    (three TF32 FLOPs each at the TF32 peak) and the rest (the transposed
    conv, conv_pre, conv_post) at the fp32 peak, or its bytes over the memory
    rate, whichever is larger."""
    ops_s = 3 * tc_flops / PEAK_TF32 + (flops - tc_flops) / PEAK_FP32
    return max(ops_s, nbytes / HBM_BYTES_PER_S) * 1e3


def resblock_work(x, blocks):
    """(fp32 FLOPs, bytes) of one resblock stage on x (N, C, T): every conv
    at its MACs per position; x, the weights and the output moved once."""
    macs = weights = 0
    for block in blocks:
        for w, b, _ in block:
            macs += w.numel()
            weights += w.numel() + b.numel()
    positions = x.shape[0] * x.shape[2]
    return 2.0 * macs * positions, 4.0 * (2 * x.numel() + weights)


def logmel_frames(t, n_fft=1024, hop=256):
    """Frames of the HiFi-GAN convention ((n_fft - hop) / 2 reflect pad)."""
    return 1 + (t + n_fft - hop - n_fft) // hop


def logmel_dft_work(b, t, n_bins, n_mels=80, n_fft=1024, hop=256):
    """(fp32 FLOPs, fp64 FLOPs, bytes) of the direct windowed DFT the TPU
    kernel and the port's first K2 ran: 2 FMAs per sample, used bin and frame
    in fp64, the dense mel projection in fp32; the waveform read and the
    log-mel written once. Kept as ``dft_bound_ms`` beside the FFT's bound."""
    frames = logmel_frames(t, n_fft, hop)
    dft = 2.0 * 2 * n_bins * n_fft * frames * b
    mel = 2.0 * n_mels * n_bins * frames * b
    return mel, dft, 4.0 * (b * t + b * n_mels * frames)


def fft_flops(n_fft, f_used):
    """fp64 FLOPs of K2's spectrum of one frame: the window (n_fft
    products), the n_fft / 2-point complex FFT (5 M log2 M), the split (16
    per used bin) and the magnitude (4 per used bin)."""
    m = n_fft // 2
    return n_fft + 5.0 * m * np.log2(m) + 20.0 * f_used


def logmel_work(b, t, f_used, nnz, n_mels=80, n_fft=1024, hop=256):
    """(fp32 FLOPs, fp64 FLOPs, bytes) of K2 on (b, t) samples: the FFT's
    spectrum per frame in fp64, the band mel in fp32 (2 per nonzero of the
    filterbank); the waveform read and the log-mel written once."""
    frames = logmel_frames(t, n_fft, hop) * b
    return 2.0 * nnz * frames, fft_flops(n_fft, f_used) * frames, \
        4.0 * (b * t + b * n_mels * logmel_frames(t, n_fft, hop))


def logmel_bwd_work(b, t, f_used, nnz, n_mels=80, n_fft=1024, hop=256):
    """(fp32 FLOPs, fp64 FLOPs, bytes) of K4's backward kernels on (b, t)
    samples: the forward's spectrum and band mel recomputed, then per frame
    dmag (2 per nonzero), the bins' gradients and C (30 per used bin), the
    inverse FFT and the window (5 M log2 M + n_fft), and the overlap-add
    (n_fft / hop adds per sample); the waveform and the mel's gradient read
    and the waveform's gradient written once (the frames' scratch is the
    kernels' own)."""
    frames = logmel_frames(t, n_fft, hop) * b
    m = n_fft // 2
    fp64 = (fft_flops(n_fft, f_used) + 2.0 * nnz + 30.0 * f_used + n_fft
            + 5.0 * m * np.log2(m)) * frames + (n_fft // hop) * b * t
    return 2.0 * nnz * frames, fp64, \
        4.0 * (2 * b * t + b * n_mels * logmel_frames(t, n_fft, hop))


class ToneStream:
    """Batches of harmonic tones drawn from the global np.random (the
    StreamRecorder pattern of tests/test_trainer.py:107): a checkpoint holds
    that state, so a resumed run replays the same batches."""

    def __init__(self, n_batches, batch=BATCH, samples=SEG):
        self.n_batches, self.batch, self.samples = n_batches, batch, samples

    def __iter__(self):
        for _ in range(self.n_batches):
            yield [tones(np.random, self.batch, self.samples)]


def build_gan(device, seed, kernel=False, precision='highest', compute_dtype=None,
              gen_precision='highest', gen_convs=False):
    """HiFi-GAN v2 with weight norm, MPD base and MSD base, initialised from
    ``seed`` with the JAX init, on ``device``. ``kernel=True`` builds the K6
    route: every critic conv (``build_critics(msd_kernel=8, mpd_kernel=True)``)
    and the generator's upsamples (``ups_backend='cuda'``) on the grouped-conv
    kernels, with ``gen_convs`` the generator's other convs too
    (``backend='cuda'``); the parameters are the same as the cuDNN route's.
    The critics run in ``precision`` and ``compute_dtype``, the generator in
    ``gen_precision``."""
    import torch
    from pytorch_sound_tpu_torch.examples.hifi_gan import build_critics
    from pytorch_sound_tpu_torch.models import build_model
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import init_params
    gen = torch.Generator().manual_seed(seed)
    route = 'cuda' if kernel else 'cudnn'
    gen_kw = {'ups_backend': route, 'precision': gen_precision}
    if kernel and gen_convs:
        gen_kw['backend'] = 'cuda'
    models = [build_model('hifi_gan_v2', extra_kwargs=gen_kw),
              *build_critics(msd_kernel=8 if kernel else -1, mpd_kernel=kernel,
                             precision=precision, compute_dtype=compute_dtype)]
    return [init_params(m, gen).to(device) for m in models]


def make_trainer(models, device, save_dir, **kw):
    """A HiFiGANTrainer at the JAX recipe's settings (AdamW 2e-4, betas 0.8 /
    0.99, no clip) that records every logged scalar."""
    from pytorch_sound_tpu_torch.examples.hifi_gan import HiFiGANTrainer
    from pytorch_sound_tpu_torch.trainer import LogType, adamw

    class Recorder(HiFiGANTrainer):
        def console_log(self, tag, meta, step):
            self.logged.append((tag, step, {k: float(np.asarray(v))
                                            for k, (v, t) in meta.items()
                                            if t == LogType.SCALAR}))
            super().console_log(tag, meta, step)

    gen, mpd, msd = models
    trainer = Recorder(gen, mpd, msd, adamw(gen.parameters(), 2e-4, 0.8, 0.99),
                       adamw(itertools.chain(mpd.parameters(), msd.parameters()),
                             2e-4, 0.8, 0.99),
                       kw.pop('train', None), kw.pop('valid', None),
                       save_dir=save_dir, save_prefix='hifi_gan', seed=kw.pop('seed', 1),
                       device=device, **kw)
    trainer.logged = []
    return trainer


def split_step_pair(specs, msd_folded=False, mel_precision='highest', detail=False, **mode):
    """One split step for each ``(device, kernel_route)`` of ``specs`` from the
    same parameters and a 2 x 8192 batch, held against the first, the models
    in ``mode`` (``build_gan``'s precision, compute_dtype, gen_precision and
    gen_convs; a spec's optional third item overrides it for that side),
    the MSD folded with ``msd_folded`` and the log-mels in
    ``mel_precision``. Both
    generator phases start from the first trainer's updated critics: Adam's
    first update moves every entry by about +-lr whatever its gradient's size,
    so entries with near-zero gradients may step apart between two correct
    runs. Returns (worst loss rel diff, (worst grad rel diff, its name), the
    losses, the parameter count); with ``detail`` also each parameter's
    gradient difference."""
    trainers = []
    for device, kernel, *extra in specs:
        models = build_gan(device, 1, kernel, **dict(mode, **(extra[0] if extra else {})))
        t = make_trainer(models, device,
                         tempfile.mkdtemp(prefix='chip_smoke_step_'),
                         max_step=1, valid_max_step=1, save_interval=1, log_interval=1,
                         msd_folded=msd_folded, mel_precision=mel_precision)
        shutil.rmtree(t.save_dir, ignore_errors=True)
        trainers.append(t)
    real = [t.to_device([tones(np.random.default_rng(5), 2, SEG)])[0][:, None, :]
            for t in trainers]
    d_loss = [t.disc_phase(r) for t, r in zip(trainers, real)]
    for key in ('mpd', 'msd'):
        getattr(trainers[1], key).load_state_dict(getattr(trainers[0], key).state_dict())
    results = []
    for t, r, (d, mel_real) in zip(trainers, real, d_loss):
        g_loss, (adv, fm, mel_l1, _) = t.gen_phase(r, mel_real)
        losses = dict(zip(LOSSES, (float(x) for x in (g_loss, d, adv, fm, mel_l1))))
        grads = {'%s.%s' % (name, k): p.grad.detach().cpu()
                 for name, m in (('gen', t.generator), ('mpd', t.mpd), ('msd', t.msd))
                 for k, p in m.named_parameters()}
        results.append((losses, grads))
    (ref_loss, ref_grads), (got_loss, got_grads) = results
    loss_rel = max(abs(got_loss[k] - ref_loss[k]) / abs(ref_loss[k]) for k in LOSSES)
    grad_rel = {k: float((got_grads[k] - g).norm() / g.norm()) for k, g in ref_grads.items()}
    worst = max(grad_rel, key=grad_rel.get)
    shown = ' '.join('%s=%.6f/%.6f' % (k, got_loss[k], ref_loss[k]) for k in LOSSES)
    out = loss_rel, (grad_rel[worst], worst), shown, len(grad_rel)
    return out + (grad_rel,) if detail else out


def time_train_steps(trainer, real, n_timed):
    """Two warm-up steps, then ``n_timed`` split steps: (steps/s by the host
    clock ending in a synchronize, per-step ms, disc / gen phase ms by CUDA
    events, peak GB). Unreachable objects (an earlier phase's trainer held
    by a reference cycle) are collected first, so the peak is this
    trainer's."""
    import torch
    dev = real.device
    for _ in range(2):
        trainer._train_step([real[:, 0]], is_logging=False)
    garbage.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3 * n_timed)]
    t0 = time.perf_counter()
    for i in range(n_timed):
        ev[3 * i].record()
        _, mel_real = trainer.disc_phase(real)
        ev[3 * i + 1].record()
        trainer.gen_phase(real, mel_real)
        ev[3 * i + 2].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    disc_ms = [ev[3 * i].elapsed_time(ev[3 * i + 1]) for i in range(n_timed)]
    gen_ms = [ev[3 * i + 1].elapsed_time(ev[3 * i + 2]) for i in range(n_timed)]
    return (n_timed / wall, wall / n_timed * 1e3, disc_ms, gen_ms,
            torch.cuda.max_memory_allocated(dev) / 1e9)


def train_path(dev, card):
    """Phase 7: returns the training path's K2 launches, the cuDNN route's
    step timing (``time_train_steps``) and the JSON entry of K4."""
    import torch
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm

    # 7.1 K4 vs its plain version at the training shape. Forward on tones
    #     against the plain version in fp64. Gradient of sum(sin(mel)) (K4's
    #     backward kernels) on white noise (the signal of
    #     tests/test_pallas.py:286) against autograd of the fp32 plain
    #     version, absolute; on tones, whose quiet bands drive the gradient
    #     to ~1e3 through 1/mel, relative to its largest entry; on both,
    #     against autograd of the plain version in fp64 for the same
    #     cotangent, relative to its largest entry.
    rng = np.random.default_rng(7)
    tonal = torch.from_numpy(tones(rng, BATCH, SEG)).to(dev)
    noise = torch.from_numpy((rng.standard_normal((BATCH, SEG)) * 0.2)
                             .astype(np.float32)).to(dev)
    mel = lm.fused_hifigan_mel_trainable(tonal)
    fwd_err = max_err(mel.double(), mel_ops.hifigan_mel_spectrogram(tonal.double()))

    def grad(fn, wav):
        w = wav.clone().requires_grad_(True)
        torch.sum(torch.sin(fn(w))).backward()
        return w.grad

    grad_err = max_err(grad(lm.fused_hifigan_mel_trainable, noise),
                       grad(mel_ops.hifigan_mel_spectrogram, noise))
    g_ref = grad(mel_ops.hifigan_mel_spectrogram, tonal)
    tone_rel = max_err(grad(lm.fused_hifigan_mel_trainable, tonal), g_ref) \
        / float(g_ref.abs().max())
    fp64_rel = 0.0
    for wav in (noise, tonal):
        cot = torch.cos(lm.fused_hifigan_mel(wav))
        ref64 = lm.hifigan_mel_vjp(wav.double(), cot.double())
        fp64_rel = max(fp64_rel, max_err(lm.hifigan_mel_backward(wav, cot).double(), ref64)
                       / float(ref64.abs().max()))
    torch.cuda.synchronize()
    log('k4', shape=tuple(tonal.shape), mel=tuple(mel.shape),
        fwd_tones_vs_fp64='%.3g' % fwd_err, grad_noise_vs_plain='%.3g' % grad_err,
        grad_tones_rel='%.3g' % tone_rel, grad_tones_max='%.4g' % float(g_ref.abs().max()),
        grad_vs_fp64_rel='%.3g' % fp64_rel)
    assert mel.shape == (BATCH, 80, SEG // 256) and fwd_err <= MEL_TOL, fwd_err
    assert grad_err <= GRAD_TOL and tone_rel <= GRAD_TOL, (grad_err, tone_rel)
    assert fp64_rel <= GRAD_TOL, fp64_rel

    # 7.2 the main path: HiFiGANTrainer(...).run() at full width, 6 steps,
    #     checkpoints at 3 and 6, deterministic cuDNN for the resume check
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    lm.fused_log_mel.launches = 0
    lm.fused_hifigan_mel_trainable.launches = 0
    lm.fused_hifigan_mel_trainable.bwd_launches = 0
    steps, valid_batches = 0, 0
    work = tempfile.mkdtemp(prefix='chip_smoke_train_')
    try:
        first_dir, resume_dir = os.path.join(work, 'first'), os.path.join(work, 'resume')
        t0 = time.perf_counter()
        run1 = make_trainer(build_gan(dev, 0), dev, first_dir, train=ToneStream(4),
                            valid=ToneStream(2), max_step=6, valid_max_step=2,
                            save_interval=3, log_interval=1)
        n_params = sum(p.numel() for m in (run1.generator, run1.mpd, run1.msd)
                       for p in m.parameters())
        best = run1.run()
        torch.cuda.synchronize()
        steps, valid_batches = steps + 6, valid_batches + 4
        train1 = {s: m for tag, s, m in run1.logged if tag == 'train'}
        for s in range(1, 7):
            log('train', step=s, **{k: '%.6f' % train1[s][k] for k in LOSSES})
        assert sorted(train1) == list(range(1, 7)), sorted(train1)
        assert all(np.isfinite(m[k]) for m in train1.values() for k in LOSSES), train1
        assert np.isfinite(best), best
        ckpt = os.path.join(first_dir, 'models', 'hifi_gan', 'Generator')
        assert sorted(os.listdir(ckpt)) == ['step_000003.chkpt', 'step_000006.chkpt'], \
            os.listdir(ckpt)
        log('run', params=n_params, steps=6, seconds='%.1f' % (time.perf_counter() - t0),
            best_valid_mel_l1='%.6f' % best, checkpoints=','.join(sorted(os.listdir(ckpt))))

        # 7.3 resume from the step-3 checkpoint alone; steps 4-6 replay
        rckpt = os.path.join(resume_dir, 'models', 'hifi_gan', 'Generator')
        os.makedirs(rckpt)
        shutil.copy(os.path.join(ckpt, 'step_000003.chkpt'), rckpt)
        del run1
        run2 = make_trainer(build_gan(dev, 0), dev, resume_dir, train=ToneStream(4),
                            valid=ToneStream(2), max_step=6, valid_max_step=2,
                            save_interval=3, log_interval=1, seed=99)
        run2.run()
        torch.cuda.synchronize()
        steps, valid_batches = steps + 3, valid_batches + 2
        train2 = {s: m for tag, s, m in run2.logged if tag == 'train'}
        assert sorted(train2) == [4, 5, 6], sorted(train2)
        worst = max(abs(train2[s][k] - train1[s][k]) / max(abs(train1[s][k]), 1e-30)
                    for s in (4, 5, 6) for k in LOSSES)
        log('resume', steps='4-6', worst_rel_diff='%.3g' % worst)
        assert worst <= RESUME_RTOL, worst
    finally:
        shutil.rmtree(work, ignore_errors=True)
    launches = {'logmel': lm.fused_log_mel.launches,
                'logmel_trainable': lm.fused_hifigan_mel_trainable.launches,
                'logmel_trainable_bwd': lm.fused_hifigan_mel_trainable.bwd_launches}
    torch.backends.cudnn.deterministic = False

    # 7.5 every step and valid batch ran K2 twice (mel_real, and the fake's
    #     mel through K4) and K4 once; every training step (not a valid
    #     batch) ran K4's backward kernels once
    log('counts', logmel=launches['logmel'], logmel_trainable=launches['logmel_trainable'],
        logmel_trainable_bwd=launches['logmel_trainable_bwd'],
        train_steps=steps, valid_batches=valid_batches)
    assert launches['logmel'] == 2 * (steps + valid_batches) > 0, launches
    assert launches['logmel_trainable'] == steps + valid_batches, launches
    assert launches['logmel_trainable_bwd'] == steps > 0, launches

    # 7.4 one step on the card against the same step on the CPU, from the
    #     same parameters and a 2 x 8192 batch (split_step_pair)
    loss_rel, (grad_rel, worst_grad), shown, n_params = split_step_pair(
        [('cpu', False), (dev, False)])
    log('card_cpu', losses=shown, worst_loss_rel='%.3g' % loss_rel,
        worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst_grad, params=n_params)
    assert loss_rel <= CARD_CPU_RTOL, (loss_rel, shown)
    assert grad_rel <= CARD_CPU_GRAD_TOL, (worst_grad, grad_rel)

    # 7.6 timings: the full-width step and its phases, K4 vs plain
    trainer = make_trainer(build_gan(dev, 0), dev, tempfile.mkdtemp(prefix='chip_smoke_t_'),
                           max_step=1, valid_max_step=1, save_interval=1, log_interval=1)
    shutil.rmtree(trainer.save_dir, ignore_errors=True)
    real = torch.from_numpy(tones(np.random.default_rng(6), BATCH, SEG)).to(dev)[:, None, :]
    step_time = time_train_steps(trainer, real, 6)
    steps_s, step_ms, disc_ms, gen_ms, peak_gb = step_time
    log('time', card=repr(card), what='train_step_16x8192',
        steps_per_s='%.3f' % steps_s, step_ms='%.2f' % step_ms,
        disc_phase_ms='/'.join('%.2f' % x for x in disc_ms),
        gen_phase_ms='/'.join('%.2f' % x for x in gen_ms),
        peak_memory_gb='%.2f' % peak_gb)
    del trainer

    def fwd_bwd(fn):
        w = tonal.clone().requires_grad_(True)
        fn(w).sum().backward()

    fwd_k, fwd_p, fwd_kr, fwd_pr = paired_ms(
        lambda: mel_ops.hifigan_mel_spectrogram(tonal),
        lambda: lm.fused_hifigan_mel_trainable(tonal), 20)
    fb_k, fb_p, _, _ = paired_ms(lambda: fwd_bwd(mel_ops.hifigan_mel_spectrogram),
                                 lambda: fwd_bwd(lm.fused_hifigan_mel_trainable), 20)
    cot = torch.cos(lm.fused_hifigan_mel(tonal))
    bwd_k, bwd_p, bwd_kr, bwd_pr = paired_ms(lambda: lm.hifigan_mel_vjp(tonal, cot),
                                             lambda: lm.hifigan_mel_backward(tonal, cot), 20)
    c = lm._constants(22050, 1024, 1024, 80, 0.0, 8000.0, str(dev))
    f_used, nnz = c.mel_w.shape[1], int((c.mel_w != 0).sum())
    bound_ms, bound_by = bound(*logmel_work(BATCH, SEG, f_used, nnz),
                               fp64_peak=PEAK_FP64_CUDA_CORES)
    dft_bound_ms, _ = bound(*logmel_dft_work(BATCH, SEG, f_used))
    bwd_bound_ms, bwd_bound_by = bound(*logmel_bwd_work(BATCH, SEG, f_used, nnz),
                                       fp64_peak=PEAK_FP64_CUDA_CORES)
    log('time', card=repr(card), what='k4_16x8192', fwd_ms='%.4f' % fwd_k,
        plain_fwd_ms='%.4f' % fwd_p, bwd_ms='%.4f' % (fb_k - fwd_k),
        plain_bwd_ms='%.4f' % (fb_p - fwd_p), bwd_kernels_ms='%.4f' % bwd_k,
        plain_vjp_ms='%.4f' % bwd_p, bwd_kernels_ms_runs='%.4f,%.4f' % bwd_kr,
        plain_vjp_ms_runs='%.4f,%.4f' % bwd_pr, fwd_ms_runs='%.4f,%.4f' % fwd_kr,
        plain_fwd_ms_runs='%.4f,%.4f' % fwd_pr, fwd_bound_ms='%.5f' % bound_ms,
        bound_by=bound_by, fwd_dft_bound_ms='%.4f' % dft_bound_ms,
        bwd_bound_ms='%.5f' % bwd_bound_ms, bwd_bound_by=bwd_bound_by,
        pr9_recorded_fwd_ms=PR9_MS['k4_fwd_16x8192'], pr9_recorded_bwd_ms=PR9_MS['k4_bwd_16x8192'])
    return launches['logmel'], step_time, {
        'name': 'logmel_trainable', 'route': 'cuda', 'source': lm.SOURCE,
        'replaces': 'pytorch_sound_tpu/ops/pallas/logmel.py:275',
        'launches': launches['logmel_trainable'], 'max_abs_err': grad_err,
        'bwd_launches': launches['logmel_trainable_bwd'], 'bwd_fp64_rel_err': fp64_rel,
        'fwd_max_abs_err': fwd_err, 'ms': fwd_k, 'plain_ms': fwd_p,
        'bwd_ms': fb_k - fwd_k, 'plain_bwd_ms': fb_p - fwd_p,
        'bwd_kernels_ms': bwd_k, 'plain_vjp_ms': bwd_p,
        'bound_ms': bound_ms, 'bound_by': bound_by, 'dft_bound_ms': dft_bound_ms,
        'bwd_bound_ms': bwd_bound_ms, 'bwd_bound_by': bwd_bound_by, 'library_ms': None}


def conv_macs(n, cout, cg, k, stride, padding, dilation, t_in, t_out):
    """Multiply-adds of a conv over the taps that land inside the input (those
    in the zero padding need no work); its dx and dw are the same products."""
    pos = (np.arange(t_out)[:, None] * stride + dilation * np.arange(k)[None, :] - padding)
    return float(n * cout * cg) * float(np.count_nonzero((pos >= 0) & (pos < t_in)))


def critic_gc_launches(mpd, msd, msd_folded=False):
    """Launches of the grouped-conv entry points (forward, dx, dw) by the
    critics in one split step, from their routes. Per critic stack with k
    layers on the kernels: the critic phase runs the forward over real +
    fake, dw of every layer and dx of every layer but the first (the
    waveform carries no gradient); the generator phase runs the forward over
    real (no gradient) and over the fake, and dx of every layer (the fake
    carries the generator's gradient) but no dw (the critics are frozen).
    The folded MSD is one stack of 8 layers on scale 0's routes, in place of
    the scales' 3 x 8."""
    fwd = dx = dw = 0
    stacks = list(mpd.children()) + ([msd.scale_0] if msd_folded else list(msd.children()))
    for sub in stacks:
        convs = [getattr(sub, 'conv_%d' % i) for i in range(sub.n_layers)] + [sub.conv_post]
        on = [c.backend == 'cuda' for c in convs]
        fwd, dw, dx = fwd + 3 * sum(on), dw + sum(on), dx + 2 * sum(on) - on[0]
    return fwd, dx, dw


def ups_gc_launches(gen, steps, valid_batches):
    """Launches of the grouped-conv entry points (forward, dx, dw) by the
    generator's upsamples: each one on the kernels runs dx (its forward) in
    both phases' generator passes and each validation batch, and in its
    backward the forward kernel (dx) and dw."""
    ups = sum(getattr(gen, 'ups_%d' % i).backend == 'cuda'
              for i in range(len(gen.upsample_rates)))
    return steps * ups, (2 * steps + valid_batches) * ups, steps * ups


def gen_gc_launches(gen, steps, valid_batches):
    """Launches of the grouped-conv entry points (forward, dx, dw) by every
    generator conv on the kernels: a conv layer runs the forward kernel in
    both phases' generator passes and each validation batch, and in its
    backward dw and, but for conv_pre (the mel carries no gradient), dx; the
    upsamples as :func:`ups_gc_launches`."""
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import WNConv1d
    convs = [m for m in gen.modules() if isinstance(m, WNConv1d) and m.backend == 'cuda']
    grads = len(convs) - int(gen.conv_pre.backend == 'cuda')
    ups = ups_gc_launches(gen, steps, valid_batches)
    return ((2 * steps + valid_batches) * len(convs) + ups[0], steps * grads + ups[1],
            steps * len(convs) + ups[2])


def expected_gc_launches(gen, mpd, msd, steps, valid_batches, msd_folded=False):
    """Launches of the grouped-conv entry points (forward, dx, dw) in
    ``steps`` split steps and ``valid_batches`` validation batches, from the
    models' routes: the critics' and the upsamples'."""
    critics = critic_gc_launches(mpd, msd, msd_folded)
    return tuple(steps * c + u for c, u in zip(critics,
                                               ups_gc_launches(gen, steps, valid_batches)))


def capture_layers(gen, mpd, msd, real, mel):
    """Every critic conv with its real input in the critic phase (the 32 x
    8192 real + fake batch through the cuDNN route, each layer fed by the one
    before it) and every generator upsample with its input (16 x 8192 output):
    [(name, module, input)]."""
    import torch
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (WNConv1d,
                                                                  WNConvTranspose1d)
    layers, hooks = [], []
    for family, model in (('gen', gen), ('mpd', mpd), ('msd', msd)):
        for name, m in model.named_modules():
            if isinstance(m, (WNConv1d, WNConvTranspose1d)) and \
                    (family != 'gen' or name.startswith('ups_')):
                hooks.append(m.register_forward_pre_hook(
                    lambda mod, inp, _n='%s.%s' % (family, name):
                    layers.append((_n, mod, inp[0].contiguous()))))
    with torch.no_grad():
        fake = gen(mel)
        both = torch.cat([real, fake], dim=0)
        mpd(both)
        msd(both)
    for h in hooks:
        h.remove()
    return layers


def kernel_route(dev, card, cudnn_step):
    """Phase 8: the K6 training route. Returns the JSON entries of the three
    grouped-conv kernels."""
    import torch
    import torch.nn.functional as F
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import WNConvTranspose1d
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm

    # 8.1 each entry point against its plain version on every conv of MPD base
    #     and MSD base at the critic phase's 32 x 8192 inputs, and at v2's four
    #     upsamples (16 x 8192 output), from seeded cotangents
    gen, mpd, msd = build_gan(dev, 0)
    real = torch.from_numpy(tones(np.random.default_rng(8), BATCH, SEG)).to(dev)[:, None, :]
    with torch.no_grad():
        mel = lm.fused_hifigan_mel(real[:, 0])
    layers = capture_layers(gen, mpd, msd, real, mel)
    del gen, mpd, msd
    rng = torch.Generator(device=dev).manual_seed(9)
    errs = {'fwd': 0.0, 'dx': 0.0, 'dw': 0.0}
    times = {e: [0.0, 0.0, 0.0] for e in errs}     # kernel, plain, library ms
    work = {e: [0.0, 0.0] for e in errs}           # FLOPs, bytes
    # FLOPs by the kernel each entry point took (tensor cores or CUDA cores)
    by_kernel = {e: {} for e in errs}
    losses = {e: [0, 0.0, 0.0] for e in errs}     # layers slower than cuDNN: count, ms, cuDNN ms

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for name, m, x in layers:
        w, b = m.folded_weight().detach(), m.bias.detach()
        if isinstance(m, WNConvTranspose1d):
            # ConvTranspose1d is the mirror conv's dx; its backward the
            # mirror's forward and dw with input and cotangent swapped
            n, _, t = x.shape
            conf = dict(stride=m.stride, padding=m.padding)
            t_up = (t - 1) * m.stride + m.kernel_size - 2 * m.padding
            gz = torch.randn((n, m.out_channels, t_up), generator=rng, device=dev)
            calls = {
                'dx': (lambda: gc.conv1d_input_grad(x, w, t_up, b, **conf),
                       lambda: gc.conv_transpose1d_reference(x, w, b, **conf),
                       lambda: F.conv_transpose1d(x, w, b, **conf)),
                'fwd': (lambda: gc.conv1d_forward(gz, w, **conf),
                        lambda: gc.grouped_conv1d_reference(gz, w, **conf),
                        lambda: F.conv1d(gz, w, **conf)),
                'dw': (lambda: gc.conv1d_weight_grad(gz, x, w.shape, **conf),
                       lambda: gc.conv1d_weight_grad_reference(gz, x, w.shape, **conf),
                       lambda: torch.ops.aten.convolution_backward(
                           x, gz, w, None, [m.stride], [m.padding], [1], False, [0], 1,
                           [False, True, False])[1])}
            macs = conv_macs(n, m.in_channels, m.out_channels, m.kernel_size, m.stride,
                             m.padding, 1, t_up, t)
            moved = {'dx': x.numel() + w.numel() + b.numel() + gz.numel(),
                     'fwd': gz.numel() + w.numel() + x.numel(),
                     'dw': gz.numel() + x.numel() + w.numel()}
            geometry = '%d->%d k%d u%d T%d' % (m.in_channels, m.out_channels,
                                              m.kernel_size, m.stride, t)
            # the mirror conv (one group): dw and fwd rows its output channels,
            # dx (the ConvTranspose1d forward) rows its input channels
            rows = {'fwd': w.shape[0], 'dx': w.shape[1], 'dw': w.shape[0]}
            depth = {'fwd': w.shape[1] * m.kernel_size,
                     'dx': gc.dx_depth(w.shape[0], m.kernel_size, m.stride, m.padding)}
        else:
            n, _, t = x.shape
            conf = dict(stride=m.stride, padding=m.padding, groups=m.groups,
                        dilation=m.dilation)
            slope = m.fused_slope
            y = gc.grouped_conv1d_reference(x, w, b, slope=slope, **conf)
            gy = torch.randn(y.shape, generator=rng, device=dev)
            conv_args = [m.stride], [m.padding], [m.dilation], False, [0], m.groups
            calls = {
                'fwd': (lambda: gc.conv1d_forward(x, w, b, slope=slope, **conf),
                        lambda: gc.grouped_conv1d_reference(x, w, b, slope=slope, **conf),
                        lambda: F.conv1d(x, w, b, **conf)),
                'dx': (lambda: gc.conv1d_input_grad(gy, w, t, **conf),
                       lambda: gc.conv1d_input_grad_reference(gy, w, t, **conf),
                       lambda: torch.ops.aten.convolution_backward(
                           gy, x, w, None, *conv_args, [True, False, False])[0]),
                'dw': (lambda: gc.conv1d_weight_grad(x, gy, w.shape, **conf),
                       lambda: gc.conv1d_weight_grad_reference(x, gy, w.shape, **conf),
                       lambda: torch.ops.aten.convolution_backward(
                           gy, x, w, None, *conv_args, [False, True, False])[1])}
            macs = conv_macs(n, m.out_channels, m.in_channels // m.groups, m.kernel_size,
                             m.stride, m.padding, m.dilation, t, y.shape[2])
            moved = {'fwd': x.numel() + w.numel() + b.numel() + y.numel(),
                     'dx': gy.numel() + w.numel() + x.numel(),
                     'dw': x.numel() + gy.numel() + w.numel()}
            geometry = '%d->%d k%d s%d g%d d%d T%d' % (m.in_channels, m.out_channels,
                                                       m.kernel_size, m.stride, m.groups,
                                                       m.dilation, t)
            rows = {'fwd': m.out_channels // m.groups, 'dx': m.in_channels // m.groups,
                    'dw': m.out_channels // m.groups}
            depth = {'fwd': m.in_channels // m.groups * m.kernel_size,
                     'dx': gc.dx_depth(m.out_channels, m.kernel_size, m.stride, m.padding,
                                       m.dilation, m.groups)}
        line = {'fwd_kernel': gc.fwd_kernel(rows['fwd'], depth['fwd']),
                'dx_kernel': gc.dx_kernel(rows['dx'], depth['dx']),
                'dw_kernel': gc.dw_kernel(rows['dw'])}
        for e in errs:
            kern = line['%s_kernel' % e]
            by_kernel[e][kern] = by_kernel[e].get(kern, 0.0) + 2.0 * macs
        for entry, (kernel, plain, library) in calls.items():
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            assert got.shape == ref.shape, (name, entry, got.shape, ref.shape)
            err = rel(got, ref)
            errs[entry] = max(errs[entry], err)
            line[entry] = '%.3g' % err
            assert err <= (GC_FWD_TOL if entry == 'fwd' else GC_GRAD_TOL), (name, entry, err)
            k_ms, p_ms = paired_ms(plain, kernel, 3)[:2]
            l_ms = cuda_ms(library, 3)
            for i, v in enumerate((k_ms, p_ms, l_ms)):
                times[entry][i] += v
            work[entry][0] += 2.0 * macs
            work[entry][1] += 4.0 * moved[entry]
            line[entry + '_ms'] = '%.3f/%.3f/%.3f' % (k_ms, p_ms, l_ms)
            if k_ms > l_ms:
                losses[entry][0] += 1
                losses[entry][1] += k_ms
                losses[entry][2] += l_ms
        log('k6', layer=name, geometry=geometry, batch=n, **line)
    del layers
    bounds = {e: bound(f, 0.0, nb) for e, (f, nb) in work.items()}
    # the layers on the tensor cores (conv_dw_kernel, conv_tap_kernel) do 3
    # TF32 FLOPs per FLOP at the TF32 peak; those on the CUDA cores
    # (conv_gemm_kernel: conv_post, a first layer's dx, v2's last upsample)
    # theirs at the fp32 peak
    tc_kernels = ('conv_dw_kernel', 'conv_tap_kernel')
    tc_flops = {e: sum(f for k_, f in by_kernel[e].items() if k_ in tc_kernels) for e in errs}
    tc_bounds = {e: max(3 * tc_flops[e] / PEAK_TF32 + (work[e][0] - tc_flops[e]) / PEAK_FP32,
                        work[e][1] / HBM_BYTES_PER_S) * 1e3 for e in errs}
    log('time', card=repr(card), what='k6_layers_one_call_each',
        **{'%s_ms' % e: '%.3f' % times[e][0] for e in errs},
        **{'%s_plain_ms' % e: '%.3f' % times[e][1] for e in errs},
        **{'%s_cudnn_ms' % e: '%.3f' % times[e][2] for e in errs},
        **{'%s_bound_ms' % e: '%.3f(%s)' % bounds[e] for e in errs},
        **{'%s_tc_bound_ms' % e: '%.3f' % tc_bounds[e] for e in errs},
        **{'%s_tc_gflop' % e: '%.1f' % (tc_flops[e] / 1e9) for e in errs},
        **{'%s_gflop' % e: '%.1f' % (work[e][0] / 1e9) for e in errs},
        **{'%s_loses_to_cudnn' % e: '%d_layers_%.3f/%.3f_ms' % tuple(losses[e]) for e in errs})

    # 8.2 the main path on the kernel route: HiFiGANTrainer(...).run() at
    #     full width, 3 steps and one validation batch, launch counts from zero
    counters = (gc.conv1d_forward, gc.conv1d_input_grad, gc.conv1d_weight_grad)
    for c in counters:
        c.launches = 0
    work_dir = tempfile.mkdtemp(prefix='chip_smoke_k6_')
    try:
        models = build_gan(dev, 0, kernel=True)
        t0 = time.perf_counter()
        run = make_trainer(models, dev, work_dir, train=ToneStream(3), valid=ToneStream(1),
                           max_step=3, valid_max_step=1, save_interval=3, log_interval=1)
        best = run.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = tuple(c.launches for c in counters)
        train = {s: m for tag, s, m in run.logged if tag == 'train'}
        for s in sorted(train):
            log('train', route='k6', step=s, **{k: '%.6f' % train[s][k] for k in LOSSES})
        assert sorted(train) == [1, 2, 3], sorted(train)
        assert all(np.isfinite(m[k]) for m in train.values() for k in LOSSES), train
        assert np.isfinite(best), best
        run_step_ms = 1e3 / train[3]['steps_per_sec']
        want = expected_gc_launches(*models, steps=3, valid_batches=1)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    log('counts', route='k6', fwd=launches[0], dx=launches[1], dw=launches[2],
        expected='%d/%d/%d' % want, train_steps=3, valid_batches=1,
        seconds='%.1f' % seconds, best_valid_mel_l1='%.6f' % best)
    assert launches == want and min(launches) > 0, (launches, want)
    del run, models

    # 8.3 card vs CPU on the kernel route (the CPU runs the plain versions)
    loss_rel, (grad_rel, worst), shown, n_params = split_step_pair(
        [('cpu', True), (dev, True)])
    log('card_cpu', route='k6', losses=shown, worst_loss_rel='%.3g' % loss_rel,
        worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst, params=n_params)
    assert loss_rel <= CARD_CPU_RTOL and grad_rel <= CARD_CPU_GRAD_TOL, (loss_rel, worst, grad_rel)

    # 8.4 kernel route vs cuDNN route, both on the card
    loss_rel, (grad_rel, worst), shown, n_params = split_step_pair(
        [(dev, False), (dev, True)])
    log('k6_cudnn', losses=shown, worst_loss_rel='%.3g' % loss_rel,
        worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst, params=n_params)
    assert loss_rel <= CARD_CPU_RTOL and grad_rel <= CARD_CPU_GRAD_TOL, (loss_rel, worst, grad_rel)

    # 8.5 the kernel route's full-width step beside phase 7.6's cuDNN route
    trainer = make_trainer(build_gan(dev, 0, kernel=True), dev,
                           tempfile.mkdtemp(prefix='chip_smoke_t_'),
                           max_step=1, valid_max_step=1, save_interval=1, log_interval=1)
    shutil.rmtree(trainer.save_dir, ignore_errors=True)
    real = torch.from_numpy(tones(np.random.default_rng(6), BATCH, SEG)).to(dev)[:, None, :]
    steps_s, step_ms, disc_ms, gen_ms, peak_gb = time_train_steps(trainer, real, 4)
    del trainer
    log('time', card=repr(card), what='train_step_16x8192_k6',
        steps_per_s='%.3f' % steps_s, step_ms='%.2f' % step_ms,
        disc_phase_ms='/'.join('%.2f' % x for x in disc_ms),
        gen_phase_ms='/'.join('%.2f' % x for x in gen_ms),
        peak_memory_gb='%.2f' % peak_gb, cudnn_steps_per_s='%.3f' % cudnn_step[0],
        cudnn_step_ms='%.2f' % cudnn_step[1], cudnn_peak_memory_gb='%.2f' % cudnn_step[4])
    replaces = {'fwd': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:414',
                'dx': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:414',
                'dw': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:763'}
    kernel_route.step_ms = {'run_8_2': run_step_ms, 'in_memory_8_5': step_ms}
    kernel_route.peak_gb = peak_gb
    return [{'name': 'grouped_conv_' + e, 'route': 'cuda', 'source': gc.SOURCE,
             'replaces': replaces[e], 'launches': launches[i], 'max_abs_err': errs[e],
             'ms': times[e][0], 'plain_ms': times[e][1], 'bound_ms': bounds[e][0],
             'bound_by': bounds[e][1], 'tc_bound_ms': tc_bounds[e],
             'layers_slower_than_library': losses[e][0], 'library_ms': times[e][2]}
            for i, e in enumerate(('fwd', 'dx', 'dw'))]


def state_tree(module):
    """A module's state dict as a JAX-style parameter tree of numpy arrays
    (the keys' '.'-separated paths as nested dicts), as ``params=`` takes it."""
    tree = {}
    for key, val in module.state_dict().items():
        *path, leaf = key.split('.')
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = val.detach().cpu().numpy()
    return tree


def v1_serving(dev, card, rng):
    """Phase 9: HiFi-GAN v1 serving. Returns the K1 launches of its stages at
    C <= 64, K1's worst error there, and the JSON entries of the wide K1
    stages and of K3."""
    import torch
    import torch.nn.functional as F
    from pytorch_sound_tpu_torch.interface.hifi_gan import InterfaceHifiGAN
    from pytorch_sound_tpu_torch.models import build_model
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (generator_apply_fused,
                                                                  init_params)
    from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm

    # the port's JAX init from a seed (kernels ~ N(0, 0.01), g their norm),
    # handed over as a (g, v) tree; the interface folds it
    tree = state_tree(init_params(build_model('hifi_gan_v1'), torch.Generator().manual_seed(0)))
    iface = InterfaceHifiGAN('hifi_gan_v1', params=tree, device='cuda')
    gen = iface.decoder
    n_params = sum(p.numel() for p in gen.parameters())
    errs = {'wide': 0.0, 'narrow': 0.0, 'resblock': 0.0}

    def held(kind, ker, ref, **fields):
        """Log a kernel output against its plain version and hold it to
        STAGE_TOL of the plain version's max abs (the weights are seeded)."""
        torch.cuda.synchronize()
        err, ref_max = max_err(ker, ref), float(ref.abs().max())
        errs[kind] = max(errs[kind], err)
        log('v1_' + kind, shape=tuple(ker.shape), max_abs_err='%.3g' % err,
            ref_max='%.3g' % ref_max, rel='%.3g' % (err / ref_max), **fields)
        assert ker.shape == ref.shape and err <= STAGE_TOL * ref_max, (kind, fields, err)

    def upsampled(x, i):
        """Stage i's resblock input from its stage input (the mel on stage 0)."""
        h = gen.conv_pre(x) if i == 0 else x
        return getattr(gen, 'ups_%d' % i)(F.leaky_relu(h, 0.1))

    # 9.1 / 9.2 each stage against its plain version, fed the plain output of
    #     the stage before; K3 on each stage's resblock input
    with torch.inference_mode():
        for batch, frames in ((2, 61), (BATCH, 256)):
            mel = iface.encode(tones(rng, batch, frames * UP))[..., :frames].contiguous()
            x = mel
            for i in range(4):
                args = gen.stage_args(i, fold_conv_pre=i == 0)
                ref = gs.generator_stage_reference(x, **args)
                held('wide' if i < 2 else 'narrow', gs.generator_stage(x, **args), ref,
                     batch=batch, frames=frames, stage=i, conv_pre=i == 0)
                h = upsampled(x, i)
                held('resblock', gs.resblock_stage(h, args['blocks']),
                     gs.resblock_stage_reference(h, args['blocks']),
                     batch=batch, frames=frames, stage=i)
                x = ref

    # 9.3 the main path, counters from zero
    gs.reset_launches()
    lm.fused_log_mel.launches = 0
    encodes = decoded = split = 0
    bench_mel = iface.encode(tones(rng, BATCH, 256 * UP))[..., :256].contiguous()
    wav = iface.decode(bench_mel)
    card_slice = iface.decode(bench_mel[:2, :, :64])
    with torch.inference_mode():
        wav_split = generator_apply_fused(gen, bench_mel, full_stage=False)
    encodes, decoded, split = encodes + 1, decoded + 2, split + 1
    torch.cuda.synchronize()
    assert wav.shape == wav_split.shape == (BATCH, 1, 256 * UP), wav.shape
    assert bool(torch.isfinite(wav).all()) and float(wav.abs().max()) <= 1.0
    cpu_slice = InterfaceHifiGAN('hifi_gan_v1', params=tree, device='cpu').decode(
        bench_mel[:2, :, :64].cpu())
    # the seeded weights put the waveform near 1e-4, so each comparison is
    # also held relative to the reference's max abs
    err_cpu = max_err(card_slice.cpu(), cpu_slice)
    err_split = max_err(wav_split, wav)
    rel_cpu = err_cpu / float(cpu_slice.abs().max())
    rel_split = err_split / float(wav.abs().max())
    log('v1_decode', params=n_params, mel=tuple(bench_mel.shape), wav=tuple(wav.shape),
        wav_max='%.4g' % float(wav.abs().max()), card_vs_cpu_max_abs_err='%.3g' % err_cpu,
        card_vs_cpu_rel='%.3g' % rel_cpu, cpu_max='%.4g' % float(cpu_slice.abs().max()),
        resblock_route_vs_full_max_abs_err='%.3g' % err_split,
        resblock_route_vs_full_rel='%.3g' % rel_split)
    assert max(err_cpu, err_split, rel_cpu, rel_split) <= DECODE_TOL, \
        (err_cpu, err_split, rel_cpu, rel_split)

    long_mel = iface.encode(tones(rng, 1, 4096 * UP))[..., :4096].contiguous()
    streamed = iface.decode_streaming(long_mel, chunk_frames=256, overlap_frames=32)
    whole = iface.decode(long_mel)
    encodes, decoded = encodes + 1, decoded + 2
    torch.cuda.synchronize()
    assert streamed.shape == whole.shape == (1, 1, 4096 * UP)
    edge = 10 * UP
    err = max_err(streamed[..., edge:-edge], whole[..., edge:-edge])
    rel = err / float(whole.abs().max())
    log('v1_stream', mel=tuple(long_mel.shape), interior_max_abs_err='%.3g' % err,
        interior_rel='%.3g' % rel, wav_max='%.4g' % float(whole.abs().max()))
    assert err <= STREAM_TOL and rel <= STREAM_TOL, (err, rel)

    # every decoded batch ran K1 four times, the two wide stages in the
    # cluster layout; the resblock route ran K3 once per stage
    launches = {'gen_stage': gs.launch_count(gs.generator_stage),
                'gen_stage_wide': gs.generator_stage.wide_launches,
                'resblock_stage': gs.launch_count(gs.resblock_stage),
                'logmel': lm.fused_log_mel.launches}
    log('counts', path='v1', decoded_batches=decoded, resblock_route_batches=split,
        encodes=encodes, **launches)
    assert launches['gen_stage'] == 4 * decoded > 0, launches
    assert launches['gen_stage_wide'] == 2 * decoded, launches
    assert launches['resblock_stage'] == 4 * split > 0, launches
    assert launches['logmel'] == encodes, launches

    # 9.4 timings, kernel and plain in turns, 3 timed calls each
    def plain_decode(m):
        x = m
        for i in range(4):
            x = gs.generator_stage_reference(x, **gen.stage_args(i, fold_conv_pre=i == 0))
        return x

    with torch.inference_mode():
        dec_k, dec_p, dec_kr, dec_pr = paired_ms(
            lambda: plain_decode(bench_mel), lambda: generator_apply_fused(gen, bench_mel), 3)
        # the plain versions of both routes are the same layers
        split_k, split_p, _, _ = paired_ms(
            lambda: plain_decode(bench_mel),
            lambda: generator_apply_fused(gen, bench_mel, full_stage=False), 3)
        stage_in, res_in = [bench_mel], []
        for i in range(4):
            res_in.append(upsampled(stage_in[-1], i))
            if i < 3:
                stage_in.append(gs.generator_stage_reference(
                    stage_in[-1], **gen.stage_args(i, fold_conv_pre=i == 0)))
        per_stage = [paired_ms(
            lambda x=x, i=i: gs.generator_stage_reference(x, **gen.stage_args(i, i == 0)),
            lambda x=x, i=i: gs.generator_stage(x, **gen.stage_args(i, i == 0)), 3)[:2]
            for i, x in enumerate(stage_in)]
        per_res = [paired_ms(
            lambda h=h, i=i: gs.resblock_stage_reference(h, gen.stage_blocks(i)),
            lambda h=h, i=i: gs.resblock_stage(h, gen.stage_blocks(i)), 3)[:2]
            for i, h in enumerate(res_in)]
        stream_ms = cuda_ms(lambda: iface.decode_streaming(long_mel), 3)
        torch_split_ms, kernel_split_ms, dec_device_ms = split_ms(
            gen, lambda: generator_apply_fused(gen, bench_mel), 2)
        wide_work = [stage_work(x, gen.stage_args(i, i == 0)) for i, x in enumerate(stage_in)]
        res_work = [resblock_work(h, gen.stage_blocks(i)) for i, h in enumerate(res_in)]
        res_tc = [resblock_flops(h.shape[0], h.shape[2], gen.stage_blocks(i))
                  for i, h in enumerate(res_in)]
    wide_bound = bound(sum(f for f, _ in wide_work[:2]), 0.0, sum(b for _, b in wide_work[:2]))
    all_bound = bound(sum(f for f, _ in wide_work), 0.0, sum(b for _, b in wide_work))
    res_bound = bound(sum(f for f, _ in res_work), 0.0, sum(b for _, b in res_work))
    wide_tc = tc_bound(sum(f for f, _ in wide_work[:2]), sum(res_tc[:2]),
                       sum(b for _, b in wide_work[:2]))
    all_tc = tc_bound(sum(f for f, _ in wide_work), sum(res_tc), sum(b for _, b in wide_work))
    res_tc_bound = tc_bound(sum(res_tc), sum(res_tc), sum(b for _, b in res_work))
    dec_samples = BATCH * 256 * UP
    log('time', card=repr(card), what='v1_decode_16x256',
        kernel_samples_per_s='%.0f' % (dec_samples / dec_k * 1e3),
        plain_samples_per_s='%.0f' % (dec_samples / dec_p * 1e3),
        kernel_ms='%.3f,%.3f' % dec_kr, plain_ms='%.3f,%.3f' % dec_pr,
        per_stage_kernel_ms='/'.join('%.3f' % k for k, _ in per_stage),
        per_stage_plain_ms='/'.join('%.3f' % p for _, p in per_stage),
        stages_bound_ms='%.3f' % all_bound[0], bound_by=all_bound[1],
        stages_tc_bound_ms='%.3f' % all_tc,
        gflop='%.1f' % (sum(f for f, _ in wide_work) / 1e9))
    log('time', card=repr(card), what='tf32_split_v1_16x256',
        split_kernel_device_ms='%.4f' % kernel_split_ms,
        decode_device_ms='%.4f' % dec_device_ms,
        share_of_decode='%.5f' % (kernel_split_ms / dec_k),
        torch_per_weight_ms='%.4f' % torch_split_ms,
        torch_share_of_decode='%.4f' % (torch_split_ms / dec_k))
    log('time', card=repr(card), what='v1_resblock_route_16x256',
        kernel_ms='%.3f' % split_k, plain_ms='%.3f' % split_p,
        per_stage_k3_ms='/'.join('%.3f' % k for k, _ in per_res),
        per_stage_plain_ms='/'.join('%.3f' % p for _, p in per_res),
        k3_bound_ms='%.3f' % res_bound[0], bound_by=res_bound[1],
        k3_tc_bound_ms='%.3f' % res_tc_bound)
    # the TF32 products the stage kernels issue (3 per fp32 FLOP, the
    # resblock convs' halo recompute not counted) against what mma.sync
    # reaches on this card alone
    rate = mma_rate_tflops(dev)
    log('time', card=repr(card), what='v1_tensor_core_share',
        mma_sync_tf32_tflops='%.1f' % rate,
        k3_tf32_tflops='%.1f' % (3 * sum(res_tc) / sum(k for k, _ in per_res) / 1e9),
        k3_share_of_mma_sync='%.3f' % (3 * sum(res_tc) / sum(k for k, _ in per_res) / 1e9 / rate))
    # K1 less K3 on the same stage: what the transposed conv and conv_pre
    # (stage 0) cost in the stage kernel, per stage and as a share of K1
    log('time', card=repr(card), what='v1_upsample_cost_16x256',
        k1_minus_k3_ms='/'.join('%.3f' % (k - r) for (k, _), (r, _) in zip(per_stage, per_res)),
        share_of_k1='/'.join('%.3f' % ((k - r) / k) for (k, _), (r, _) in zip(per_stage, per_res)))
    log('time', card=repr(card), what='v1_stream_1x4096',
        kernel_samples_per_s='%.0f' % (4096 * UP / stream_ms * 1e3),
        kernel_ms='%.3f' % stream_ms)
    narrow = launches['gen_stage'] - launches['gen_stage_wide']
    return narrow, errs['narrow'], [
        {'name': 'gen_stage_wide', 'route': 'cuda', 'source': gs.SOURCE,
         'replaces': 'pytorch_sound_tpu/ops/pallas/gen_stage.py:282',
         'launches': launches['gen_stage_wide'], 'max_abs_err': errs['wide'],
         'ms': per_stage[0][0] + per_stage[1][0], 'plain_ms': per_stage[0][1] + per_stage[1][1],
         'bound_ms': wide_bound[0], 'bound_by': wide_bound[1], 'tc_bound_ms': wide_tc,
         'library_ms': None},
        {'name': 'resblock_stage', 'route': 'cuda', 'source': gs.SOURCE,
         'replaces': 'pytorch_sound_tpu/ops/pallas/resblock.py:155',
         'launches': launches['resblock_stage'], 'max_abs_err': errs['resblock'],
         'ms': sum(k for k, _ in per_res), 'plain_ms': sum(p for _, p in per_res),
         'bound_ms': res_bound[0], 'bound_by': res_bound[1], 'tc_bound_ms': res_tc_bound,
         'library_ms': None}]


ATTENTION_FLOPS = {'fwd': 4, 'dkv': 8, 'dq': 6}   # per (query, key) pair and per D


META_FILES = ['all_meta.json', 'train_meta.json', 'val_meta.json']


def same_state(a, b):
    """Two checkpoint states equal bit for bit."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_state(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


class LogLines(logging.Handler):
    """The trainer's log lines with their times, and the scalars of its
    'train' lines by step."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append((record.created, record.getMessage()))

    def train_steps(self):
        """({step: {name: value}}, {step: time}) of the 'train' lines."""
        steps, times = {}, {}
        for created, msg in self.lines:
            parts = msg.split('\t')
            if parts[0] == 'train':
                step = int(parts[1].split()[0])
                steps[step] = {k: float(v) for k, v in (p.split(': ') for p in parts[2:])}
                times[step] = created
        return steps, times


def recipe_path(dev, card, k6_step_ms):
    """Phase 11: the recipe from wav files on disk. A VCTK tree under $TMPDIR,
    the port's metas of it, then ``examples.hifi_gan.main`` on the K6 route
    (6 steps; 3 steps and a resume to 6, whose step-6 checkpoint must equal
    the first run's bit for bit), on the default route (2 steps), and once
    as a command. Returns the K2, K4, K4-backward and K6 (forward, dx, dw)
    launches of the in-process runs."""
    import random
    import torch
    from pytorch_sound_tpu_torch.data.meta.vctk import VCTKMeta, get_datasets
    from pytorch_sound_tpu_torch.examples import hifi_gan as recipe
    from pytorch_sound_tpu_torch.models import build_model
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    from pytorch_sound_tpu_torch.utils.commons import LOGGER
    from pytorch_sound_tpu_torch.utils.wavio import write_wav

    counters = (lm.fused_log_mel, lm.fused_hifigan_mel_trainable,
                gc.conv1d_forward, gc.conv1d_input_grad, gc.conv1d_weight_grad)
    totals = np.zeros(6, dtype=np.int64)

    def run_main(meta, save_dir, max_step, save_interval=3, **kw):
        """main() with every counter from zero; returns (best, launches (K2,
        K4, K4 bwd, K6 fwd, dx, dw), {step: logged scalars}, step times)."""
        for c in counters:
            c.launches = 0
        lm.fused_hifigan_mel_trainable.bwd_launches = 0
        lines = LogLines()
        LOGGER.addHandler(lines)
        np.random.seed(0)
        torch.manual_seed(0)
        try:
            best = recipe.main('vctk', meta, save_dir, batch_size=BATCH, num_workers=0,
                               fix_len=SEG, max_step=max_step, valid_max_step=1,
                               save_interval=save_interval, log_interval=1, device=str(dev),
                               **kw)
            torch.cuda.synchronize()
        finally:
            LOGGER.removeHandler(lines)
        launches = (lm.fused_log_mel.launches, lm.fused_hifigan_mel_trainable.launches,
                    lm.fused_hifigan_mel_trainable.bwd_launches,
                    *(c.launches for c in counters[2:]))
        totals[:] += launches
        return (best, launches, *lines.train_steps())

    def expected(kernel, steps, valid):
        gen = build_model('hifi_gan_v2')
        mpd, msd = recipe.build_critics(msd_kernel=8 if kernel else -1, mpd_kernel=kernel)
        return (2 * (steps + valid), steps + valid, steps,
                *expected_gc_launches(gen, mpd, msd, steps, valid))

    deterministic = torch.backends.cudnn.deterministic
    work = tempfile.mkdtemp(prefix='chip_smoke_recipe_')
    try:
        # 11.1 a VCTK tree: 4 speakers x 24 utterances of 2.05-4 s (the metas
        #      keep 2 < duration < 15 s), harmonic tones with noise, int16 PCM
        rng = np.random.default_rng(11)
        raw = os.path.join(work, 'raw')
        n_bytes = 0
        for s in range(4):
            spk = 'p%03d' % (225 + s)
            for sub in ('wav', 'txt'):
                os.makedirs(os.path.join(raw, spk, sub))
            for u in range(24):
                key = '%s_%03d' % (spk, u)
                path = os.path.join(raw, spk, 'wav', key + '.wav')
                write_wav(path, tones(rng, 1, int(SR * rng.uniform(2.05, 4.0)))[0], SR,
                          dtype='int16')
                n_bytes += os.path.getsize(path)
                with open(os.path.join(raw, spk, 'txt', key + '.txt'), 'w') as f:
                    f.write('Utterance %d of speaker %s.' % (u, spk))

        # 11.2 the metas
        meta = os.path.join(work, 'meta')
        random.seed(0)
        t0 = time.perf_counter()
        VCTKMeta(meta).make_meta(raw)
        meta_s = time.perf_counter() - t0
        rows = [len(VCTKMeta(os.path.join(meta, name))) for name in META_FILES]
        speakers = VCTKMeta(os.path.join(meta, META_FILES[0])).num_speakers
        log('meta', wav_mb='%.1f' % (n_bytes / 1e6), files=sorted(os.listdir(meta)),
            rows='/'.join(map(str, rows)), speakers=speakers)
        assert sorted(os.listdir(meta)) == META_FILES and rows == [96, 88, 8] \
            and speakers == 4, (os.listdir(meta), rows, speakers)

        # 11.7 (first part) the train loader alone, one epoch per run: a warm
        #      epoch, then 0 and 2 worker threads in turns
        loader_ms = {0: [], 2: []}
        for workers in (0, 0, 2, 2, 0):
            train, _ = get_datasets(meta, BATCH, workers, fix_len=SEG, pad_multiple=SEG)
            t0 = time.perf_counter()
            batches = list(train)
            loader_ms[workers].append((time.perf_counter() - t0) / len(batches) * 1e3)
            assert len(batches) == len(train) == 5 and batches[0][0].shape == (BATCH, SEG)
        loader_ms[0].pop(0)

        # 11.3 main on the kernel route, 6 steps, checkpoints at 3 and 6
        torch.backends.cudnn.deterministic = True
        save_a = os.path.join(work, 'save_a')
        kernel = dict(msd_pallas=8, mpd_pallas=True)
        t0 = time.perf_counter()
        best, launches, steps, times = run_main(meta, save_a, 6, **kernel)
        main_s = time.perf_counter() - t0
        want = expected(True, 6, 2)
        for s_ in sorted(steps):
            log('train', route='recipe_k6', step=s_, **{k: '%.6f' % steps[s_][k] for k in LOSSES})
        ckpt_a = os.path.join(save_a, 'models', 'hifi_gan', 'Generator')
        log('counts', route='recipe_k6', logmel=launches[0], logmel_trainable=launches[1],
            logmel_trainable_bwd=launches[2], fwd=launches[3], dx=launches[4], dw=launches[5],
            expected='/'.join(map(str, want)), train_steps=6, valid_batches=2,
            seconds='%.1f' % main_s, best_valid_mel_l1='%.6f' % best,
            checkpoints=','.join(sorted(os.listdir(ckpt_a))))
        assert sorted(steps) == list(range(1, 7)), sorted(steps)
        assert all(np.isfinite(m[k]) for m in steps.values() for k in LOSSES), steps
        assert np.isfinite(best) and launches == want, (best, launches, want)
        assert sorted(os.listdir(ckpt_a)) == ['step_000003.chkpt', 'step_000006.chkpt']
        assert os.path.exists(os.path.join(save_a, 'models', 'hifi_gan', 'Generator.best.chkpt'))
        # wall time between consecutive steps' log lines (the batch's load
        # and transfer included), leaving out the gap with step 3's
        # validation and checkpoint, beside the trainer's own step time
        wall = [(times[i + 1] - times[i]) * 1e3 for i in (1, 2, 4, 5)]
        trainer_ms = 1e3 / steps[6]['steps_per_sec']

        # 11.4 3 steps, then a resume to 6: the step-6 checkpoint is the
        #      first run's, bit for bit (the loaders' positions, crops and
        #      bucket draws replay)
        save_b = os.path.join(work, 'save_b')
        _, launches_b1, _, _ = run_main(meta, save_b, 3, **kernel)
        _, launches_b2, steps_b, _ = run_main(meta, save_b, 6, **kernel)
        state_a, state_b = (torch.load(os.path.join(d, 'models', 'hifi_gan', 'Generator',
                                                    'step_000006.chkpt'),
                                       map_location='cpu', weights_only=True)
                            for d in (save_a, save_b))
        same = same_state(state_a, state_b)
        log('resume', route='recipe_k6', steps='4-6', logged=sorted(steps_b),
            checkpoint_bit_identical=same,
            launches='/'.join(map(str, np.add(launches_b1, launches_b2))))
        assert sorted(steps_b) == [4, 5, 6] and same, (sorted(steps_b), same)
        assert tuple(launches_b1) == expected(True, 3, 1) == tuple(launches_b2)
        del state_a, state_b
        for d in (save_a, save_b):
            shutil.rmtree(d)
        torch.backends.cudnn.deterministic = deterministic

        # 11.5 the default route (every critic conv on cuDNN): 2 steps, K2
        #      and K4 only
        best_c, launches_c, steps_c, _ = run_main(meta, os.path.join(work, 'save_c'), 2)
        log('counts', route='recipe_cudnn', logmel=launches_c[0],
            logmel_trainable=launches_c[1], logmel_trainable_bwd=launches_c[2],
            k6='%d/%d/%d' % launches_c[3:], expected='/'.join(map(str, expected(False, 2, 0))))
        assert sorted(steps_c) == [1, 2] and launches_c == expected(False, 2, 0), launches_c
        assert all(np.isfinite(m[k]) for m in steps_c.values() for k in LOSSES), steps_c

        # 11.6 the command line, in a process of its own
        save_d = os.path.join(work, 'save_d')
        root = os.path.dirname(os.path.abspath(__file__))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'pytorch_sound_tpu_torch.examples.hifi_gan', 'vctk', meta,
             save_d, '--batch_size', str(BATCH), '--num_workers', '2', '--max_step', '2',
             '--save_interval', '2', '--valid_max_step', '1', '--log_interval', '1'],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        cli_ckpt = os.path.join(save_d, 'models', 'hifi_gan', 'Generator', 'step_000002.chkpt')
        log('cli', returncode=proc.returncode, seconds='%.1f' % (time.perf_counter() - t0),
            checkpoint=os.path.exists(cli_ckpt),
            last_line=repr(proc.stderr.strip().splitlines()[-1] if proc.stderr.strip() else ''))
        assert proc.returncode == 0 and os.path.exists(cli_ckpt), proc.stdout + proc.stderr
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(work, ignore_errors=True)

    # 11.7 whether the loader keeps up: its ms per batch against the step
    log('time', card=repr(card), what='recipe_16x8192', make_meta_s='%.3f' % meta_s,
        loader_ms_per_batch_w0='/'.join('%.2f' % x for x in loader_ms[0]),
        loader_ms_per_batch_w2='/'.join('%.2f' % x for x in loader_ms[2]),
        main_step_wall_ms='/'.join('%.2f' % x for x in wall),
        main_trainer_step_ms='%.2f' % trainer_ms,
        phase8_run_step_ms='%.2f' % k6_step_ms['run_8_2'],
        phase8_in_memory_step_ms='%.2f' % k6_step_ms['in_memory_8_5'])
    return totals


def attention_work(n, h, tq, tk, d, lengths=None):
    """{kernel: (fp32 FLOPs, bytes)} the three flash-attention functions need:
    per (query, valid key) pair 4 D FLOPs in the forward, 8 D in dK / dV, 6 D
    in dQ, summed over the items' valid key counts ``lengths`` (all Tk when
    None; masked keys change no output); each input read and each output
    written once (q, k, v, the mask, o and lse; do, lse and di; the
    gradients)."""
    valid = n * tk if lengths is None else sum(lengths)
    pairs, q_el, k_el = float(h * tq * valid * d), n * h * tq * d, n * h * tk * d
    rows, mask = n * h * tq, 0 if lengths is None else n * tk
    by = {'fwd': 4.0 * (2 * q_el + 2 * k_el + rows + mask),
          'dkv': 4.0 * (2 * q_el + 4 * k_el + 2 * rows + mask),
          'dq': 4.0 * (3 * q_el + 2 * k_el + 2 * rows + mask)}
    return {e: (ATTENTION_FLOPS[e] * pairs, by[e]) for e in by}


def key_valid_from_spans(spans, t, dev):
    """(N, t) float32 key validity, 1 inside each item's (start, end) spans;
    an item with no span has every key masked."""
    import torch
    kv = torch.zeros((len(spans), t), device=dev)
    for i, item in enumerate(spans):
        for a, b in item:
            kv[i, a:b] = 1.0
    return kv


def key_valid_from_lengths(lengths, t, dev):
    """(N, t) float32 key validity, 1 for the first ``lengths[i]`` keys."""
    import torch
    return (torch.arange(t, device=dev)[None, :]
            < torch.tensor(lengths, device=dev)[:, None]).float()


def attention_path(dev, card):
    """Phase 10: the flash-attention kernels (K5) and the blockwise
    MultiHeadAttention route that runs them. Returns their JSON entries."""
    import torch
    import torch.nn.functional as F
    from pytorch_sound_tpu_torch.models.modules import MultiHeadAttention
    from pytorch_sound_tpu_torch.ops.attention import blockwise_attention
    from pytorch_sound_tpu_torch.ops.cuda import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(10)
    errs = {'fwd': 0.0, 'dkv': 0.0, 'dq': 0.0}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    def held(kind, got, ref, tol, **fields):
        """Log a kernel output against its plain version and hold the max abs
        error to ``tol`` of the plain version's max abs."""
        torch.cuda.synchronize()
        err, r = max_err(got, ref), rel(got, ref)
        errs[kind] = max(errs[kind], err)
        log('k5_' + kind, max_abs_err='%.3g' % err, rel='%.3g' % r, **fields)
        assert got.shape == ref.shape and r <= tol, (kind, fields, r)

    def qkv(n, h, tq, tk, d):
        return [torch.randn((n, h, t, d), generator=gen, device=dev) for t in (tq, tk, tk)]

    # 10.1 each kernel against its plain version: (a) the JAX bench shapes,
    #      (b) a ragged T with a key mask (every item keeps a key), (c) D = 160,
    #      (e) masks the kernels' tile skip reads: whole masked tiles inside
    #      an item (keys 1024-2047), an item with every key masked (not
    #      skipped: p = 1 on each key), mask edges inside a tile, leading
    #      masked tiles (the forward skips them and its first live tile's
    #      alpha = 0), a ragged T, and D = 128, where dK / dV splits the head
    #      width between warps (key valid spans per item); the forward also
    #      as K5a, without the logsumexp
    spans = {'all': ((0, 4096),), 'mid': ((0, 1024), (2048, 4096)), 'none': (),
             'edge': ((0, 1000),), 'ragged': ((0, 100), (900, 1500)),
             'ragged2': ((0, 300), (500, 777)), 'late': ((1000, 4096),),
             'tail': ((4000, 4096),)}
    for n, h, t, d, mask in ((4, 8, 2048, 64, None), (4, 8, 4096, 64, None),
                             (4, 8, 4001, 64, (4001, 3001, 2001, 1)),
                             (2, 4, 1000, 160, (1000, 517)),
                             (4, 8, 4096, 64, ('all', 'mid', 'none', 'edge')),
                             (2, 8, 4096, 64, ('late', 'tail')),
                             (2, 4, 1500, 64, ('ragged', 'none')),
                             (2, 4, 777, 128, ('ragged2', 'none'))):
        q, k, v = qkv(n, h, t, t, d)
        if mask is None or isinstance(mask[0], int):
            kv = None if mask is None else key_valid_from_lengths(mask, t, dev)
        else:
            kv = key_valid_from_spans([spans[m] for m in mask], t, dev)
        shape = dict(shape=(n, h, t, d), mask=mask)
        o, lse = fa.attention_forward(q, k, v, kv)
        o_ref, lse_ref = fa.attention_reference(q, k, v, kv)
        held('fwd', o, o_ref, FLASH_FWD_TOL, out='o', **shape)
        held('fwd', lse, lse_ref, FLASH_FWD_TOL, out='lse', **shape)
        o_k5a, no_lse = fa.attention_forward(q, k, v, kv, with_lse=False)
        held('fwd', o_k5a, o_ref, FLASH_FWD_TOL, out='o_k5a', **shape)
        assert no_lse is None and torch.equal(o_k5a, o), shape
        dout = torch.randn(o.shape, generator=gen, device=dev)
        di = (o_ref * dout).sum(dim=-1)
        dk, dv = fa.attention_dkv(q, k, v, kv, dout, lse_ref, di)
        dk_ref, dv_ref = fa.attention_dkv_reference(q, k, v, kv, dout, lse_ref, di)
        held('dkv', dk, dk_ref, FLASH_GRAD_TOL, out='dk', **shape)
        held('dkv', dv, dv_ref, FLASH_GRAD_TOL, out='dv', **shape)
        dq = fa.attention_dq(q, k, v, kv, dout, lse_ref, di)
        held('dq', dq, fa.attention_dq_reference(q, k, v, kv, dout, lse_ref, di),
             FLASH_GRAD_TOL, out='dq', **shape)
        if kv is not None:
            # masked keys of an item with a valid key: exactly zero (p = 0),
            # whether their tile was skipped or computed
            dead = (kv < 0.5) & (kv > 0.5).any(dim=1, keepdim=True)
            for got in (dk, dv):
                assert not bool(got.permute(0, 2, 1, 3)[dead].any()), shape
        # no atomics: a rerun is bit-identical
        again = fa.attention_forward(q, k, v, kv)
        assert torch.equal(again[0], o) and torch.equal(again[1], lse)
        assert torch.equal(fa.attention_dkv(q, k, v, kv, dout, lse_ref, di)[0], dk)
        assert torch.equal(fa.attention_dq(q, k, v, kv, dout, lse_ref, di), dq)
        del q, k, v, o, o_ref, o_k5a, again, dout, dk, dv, dk_ref, dv_ref, dq, kv

    # (d) T = 16384: a dense plain score tensor would take 34 GB, so the
    #     forward is held against the plain scan and the gradients, through
    #     the autograd function, on one (n, h) slice against the dense plain
    #     backward of that slice
    q, k, v = (t.requires_grad_(True) for t in qkv(4, 8, 16384, 16384, 64))
    out = fa.flash_attention_trainable(q, k, v)
    with torch.no_grad():
        scan = blockwise_attention(q, k, v, block_size=1024, backend='scan')
    held('fwd', out.detach(), scan, FLASH_FWD_TOL, out='o_vs_scan', shape=(4, 8, 16384, 64))
    dout = torch.randn(out.shape, generator=gen, device=dev)
    out.backward(dout)
    with torch.no_grad():
        sl = [t[1:2, 3:4].detach() for t in (q, k, v, dout)]
        o1, lse1 = fa.attention_reference(*sl[:3])
        di1 = (o1 * sl[3]).sum(dim=-1)
        dk1, dv1 = fa.attention_dkv_reference(*sl[:3], None, sl[3], lse1, di1)
        dq1 = fa.attention_dq_reference(*sl[:3], None, sl[3], lse1, di1)
    held('dq', q.grad[1:2, 3:4], dq1, FLASH_GRAD_TOL, out='dq_slice', shape=(4, 8, 16384, 64))
    held('dkv', k.grad[1:2, 3:4], dk1, FLASH_GRAD_TOL, out='dk_slice', shape=(4, 8, 16384, 64))
    held('dkv', v.grad[1:2, 3:4], dv1, FLASH_GRAD_TOL, out='dv_slice', shape=(4, 8, 16384, 64))
    del q, k, v, out, scan, dout, sl, o1, dk1, dv1, dq1

    # 10.2 the main path: MultiHeadAttention(512, 8) at 4 x 4096 with the
    #      default block_size=0, so the auto route takes the kernels; seeded
    #      weights, key lengths 4096 / 3500 / 2900 / 2048; counters from zero
    torch.manual_seed(10)
    mha = MultiHeadAttention(hidden_dim=512, heads=8).to(dev)
    dense = MultiHeadAttention(hidden_dim=512, heads=8, block_size=-1).to(dev)
    dense.load_state_dict(mha.state_dict())
    n, t = 4, MHA_T
    lengths = (4096, 3500, 2900, 2048)
    mask = key_valid_from_lengths(lengths, t, dev) < 0.5
    x0 = torch.randn((n, 512, t), generator=gen, device=dev)
    w = torch.randn((n, 512, t), generator=gen, device=dev)
    assert mha.uses_blockwise(t) and not dense.uses_blockwise(t)
    counters = (fa.attention_forward, fa.attention_dkv, fa.attention_dq)
    for c in counters:
        c.launches = 0
    x = x0.clone().requires_grad_(True)
    out, att = mha(x, mask)
    (out * w).sum().backward()
    with torch.no_grad():
        again, _ = mha(x0, mask)
    passes, backward_passes = 2, 1          # the blockwise calls above
    torch.cuda.synchronize()
    launches = tuple(c.launches for c in counters)
    assert rel(again, out.detach()) <= MHA_TOL

    kernel_grads = {'input': x.grad, **{k_: p.grad for k_, p in mha.named_parameters()}}
    assert att is None and out.shape == (n, 512, t) and bool(torch.isfinite(out).all())
    log('counts', path='mha_4x4096', forward=launches[0], dkv=launches[1], dq=launches[2],
        blockwise_calls=passes, backward_passes=backward_passes)
    assert launches == (passes, backward_passes, backward_passes), launches

    x = x0.clone().requires_grad_(True)
    out_d, att_d = dense(x, mask)
    (out_d * w).sum().backward()
    torch.cuda.synchronize()
    assert tuple(c.launches for c in counters) == launches, 'the dense route launched a kernel'
    dense_grads = {'input': x.grad, **{k_: p.grad for k_, p in dense.named_parameters()}}
    grad_rel = {k_: float((g - dense_grads[k_]).norm() / dense_grads[k_].norm())
                for k_, g in kernel_grads.items()}
    fwd_rel = rel(out.detach(), out_d.detach())
    cpu = MultiHeadAttention(hidden_dim=512, heads=8)
    cpu.load_state_dict({k_: p.cpu() for k_, p in mha.state_dict().items()})
    with torch.no_grad():
        out_cpu, _ = cpu(x0.cpu(), mask.cpu())
    cpu_rel = rel(out.detach().cpu(), out_cpu)
    log('mha', shape=(n, 512, t), heads=8, lengths=lengths, att_dense=tuple(att_d.shape),
        fwd_vs_dense_rel='%.3g' % fwd_rel, fwd_vs_cpu_rel='%.3g' % cpu_rel,
        **{'grad_rel_' + k_: '%.3g' % g for k_, g in grad_rel.items()})
    assert fwd_rel <= MHA_TOL and cpu_rel <= MHA_TOL, (fwd_rel, cpu_rel)
    assert max(grad_rel.values()) <= MHA_GRAD_TOL, grad_rel
    del out, out_d, att_d, x, kernel_grads, dense_grads

    # 10.3 timings, CUDA events, plain and kernel in turns
    def fwd_bwd(fn, q, k, v, kv, dout):
        leaves = [t_.detach().requires_grad_(True) for t_ in (q, k, v)]
        fn(*leaves, kv).backward(dout)

    def plain_trainable(q, k, v, kv):
        return fa.attention_reference(q, k, v, kv)[0]

    def sdpa(q, k, v, kv):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=kv[:, None, None, :] > 0.5)

    entry_times = {}
    for t_ in (2048, 4096, 16384):
        q, k, v = qkv(4, 8, t_, t_, 64)
        lengths = (t_, t_ * 7 // 8, t_ * 5 // 8, t_ // 2)
        kv = key_valid_from_lengths(lengths, t_, dev)
        dout = torch.randn(q.shape, generator=gen, device=dev)
        iters = 2 if t_ > 4096 else 5
        fields = {}
        if t_ <= 4096:
            f_k, f_p = paired_ms(lambda: fa.attention_reference(q, k, v, kv),
                                 lambda: fa.attention_forward(q, k, v, kv), iters)[:2]
            fb_k, fb_p = paired_ms(lambda: fwd_bwd(plain_trainable, q, k, v, kv, dout),
                                   lambda: fwd_bwd(fa.flash_attention_trainable, q, k, v,
                                                   kv, dout), iters)[:2]
            fields.update(plain_fwd_ms='%.3f' % f_p, plain_fwd_bwd_ms='%.3f' % fb_p)
        else:
            # the dense plain version does not fit; the plain scan's forward
            f_k, f_p = paired_ms(
                lambda: blockwise_attention(q, k, v, mask=kv < 0.5, block_size=1024,
                                            backend='scan'),
                lambda: fa.attention_forward(q, k, v, kv), iters)[:2]
            fb_k = cuda_ms(lambda: fwd_bwd(fa.flash_attention_trainable, q, k, v, kv, dout),
                           iters)
            fields.update(plain_scan_fwd_ms='%.3f' % f_p, plain_fwd_bwd_ms='not measured')
        o, lse = fa.attention_forward(q, k, v, kv)
        di = (o * dout).sum(dim=-1)
        calls = {'dkv': (lambda: fa.attention_dkv_reference(q, k, v, kv, dout, lse, di),
                         lambda: fa.attention_dkv(q, k, v, kv, dout, lse, di)),
                 'dq': (lambda: fa.attention_dq_reference(q, k, v, kv, dout, lse, di),
                        lambda: fa.attention_dq(q, k, v, kv, dout, lse, di))}
        if t_ <= 4096:
            (dkv_k, dkv_p), (dq_k, dq_p) = (paired_ms(*calls[e], iters)[:2] for e in calls)
            fields.update(plain_dkv_ms='%.3f' % dkv_p, plain_dq_ms='%.3f' % dq_p)
        else:   # the plain versions' scores do not fit
            dkv_k, dq_k = (cuda_ms(calls[e][1], iters) for e in calls)
        lib = lib_bwd = None
        if t_ <= 4096:
            lib = cuda_ms(lambda: sdpa(q, k, v, kv), iters)
            lib_fb = cuda_ms(lambda: fwd_bwd(sdpa, q, k, v, kv, dout), iters)
            leaves = [a.detach().requires_grad_(True) for a in (q, k, v)]
            o_lib = sdpa(*leaves, kv)
            # SDPA's backward is one call for dq, dk and dv together
            lib_bwd = cuda_ms(lambda: torch.autograd.grad(o_lib, leaves, dout,
                                                          retain_graph=True), iters)
            fields.update(sdpa_fwd_ms='%.3f' % lib, sdpa_fwd_bwd_ms='%.3f' % lib_fb,
                          sdpa_bwd_ms='%.3f' % lib_bwd)
            del leaves, o_lib
        # the bound counts the valid keys only; the *_implemented_* fields
        # count the keys each kernel processes, every key of a live tile
        # (fa.live_key_tiles); the *_tc_bound_* fields put the kernels' 3xTF32
        # products at the tensor cores' TF32 peak
        work = attention_work(4, 8, t_, t_, 64, lengths)
        bounds = {e: bound(f, 0.0, b) for e, (f, b) in work.items()}
        keys = {}
        for e, tile in zip(('fwd', 'dkv', 'dq'),
                           (fa.forward_key_tile(64), *fa.backward_key_tiles(64))):
            live = fa.live_key_tiles(kv, tile).float()
            widths = torch.full((live.shape[1],), float(tile), device=dev)
            widths[-1] = t_ - tile * (live.shape[1] - 1)
            keys[e] = float((live * widths).sum())
        implemented = {e: bound(ATTENTION_FLOPS[e] * 8 * t_ * keys[e] * 64.0, 0.0, b)
                       for e, (_, b) in work.items()}
        tc_bounds = {e: max(3 * work[e][0] / PEAK_TF32, work[e][1] / HBM_BYTES_PER_S) * 1e3
                     for e in work}
        log('time', card=repr(card), what='k5_4x8x%dx64' % t_, lengths=lengths,
            fwd_ms='%.3f' % f_k, fwd_bwd_ms='%.3f' % fb_k, dkv_ms='%.3f' % dkv_k,
            dq_ms='%.3f' % dq_k, **fields,
            **{'%s_bound_ms' % e: '%.3f' % b[0] for e, b in bounds.items()},
            **{'%s_gflop' % e: '%.1f' % (f / 1e9) for e, (f, _) in work.items()},
            **{'%s_implemented_bound_ms' % e: '%.3f' % b[0] for e, b in implemented.items()},
            **{'%s_tc_bound_ms' % e: '%.3f' % b for e, b in tc_bounds.items()},
            **{'%s_mbytes' % e: '%.1f' % (b / 1e6) for e, (_, b) in work.items()},
            bwd_kernels_ms='%.3f' % (dkv_k + dq_k))
        if t_ == MHA_T:
            entry_times = {'fwd': (f_k, f_p, lib), 'dkv': (dkv_k, dkv_p, lib_bwd),
                           'dq': (dq_k, dq_p, lib_bwd), 'bounds': bounds,
                           'implemented': implemented, 'tc': tc_bounds}
        del q, k, v, dout, o, lse, di

    # MultiHeadAttention forward + backward, kernel route vs dense route, at
    # the main path's T and below it (where the kernel overtakes dense); the
    # layout copies into and out of the kernel's (N * H, T, D)
    blocky = MultiHeadAttention(hidden_dim=512, heads=8, auto_threshold=1).to(dev)
    blocky.load_state_dict(mha.state_dict())
    for t_ in (256, 512, 1024, 2048, MHA_T):
        xs = x0[..., :t_].contiguous()
        m_ = mask[:, :t_]
        ws = w[..., :t_].contiguous()

        def step(module):
            xx = xs.detach().requires_grad_(True)
            (module(xx, m_)[0] * ws).sum().backward()

        # more calls at small T, where one step is a few ms of host time
        k_ms, d_ms = paired_ms(lambda: step(dense), lambda: step(blocky),
                               3 * MHA_T // t_)[:2]
        log('time', card=repr(card), what='mha_fwd_bwd_4x512x%d' % t_,
            kernel_route_ms='%.3f' % k_ms, dense_route_ms='%.3f' % d_ms, kernel_steps_per_s='%.2f' % (1e3 / k_ms),
            dense_steps_per_s='%.2f' % (1e3 / d_ms))
    qh = torch.randn((n, t, 8, 64), generator=gen, device=dev)
    copy_ms = cuda_ms(lambda: [qh.transpose(1, 2).contiguous() for _ in range(4)], 10)
    log('time', card=repr(card), what='mha_layout_copies_4x4096', q_k_v_out_ms='%.3f' % copy_ms)

    names = {'fwd': ('flash_fwd', 'pytorch_sound_tpu/ops/pallas/flash_attention.py:92'),
             'dkv': ('flash_dkv', 'pytorch_sound_tpu/ops/pallas/flash_attention.py:380'),
             'dq': ('flash_dq', 'pytorch_sound_tpu/ops/pallas/flash_attention.py:411')}
    # SDPA's backward is one call for dq, dk and dv: it is the library time of
    # flash_dkv and flash_dq together, not of either alone
    scope = {'fwd': 'forward', 'dkv': 'dq+dk+dv', 'dq': 'dq+dk+dv'}
    return [{'name': names[e][0], 'route': 'cuda', 'source': fa.SOURCE,
             'replaces': names[e][1] + (' and :322' if e == 'fwd' else ''),
             'launches': launches[i], 'max_abs_err': errs[e],
             'ms': entry_times[e][0], 'plain_ms': entry_times[e][1],
             'bound_ms': entry_times['bounds'][e][0], 'bound_by': entry_times['bounds'][e][1],
             'implemented_bound_ms': entry_times['implemented'][e][0],
             'tc_bound_ms': entry_times['tc'][e],
             'library_ms': entry_times[e][2], 'library_scope': scope[e]}
            for i, e in enumerate(('fwd', 'dkv', 'dq'))]


# (sample rate, n_fft, hop, mels, fmax): n_fft that are not powers of two and
# that K2 takes on its mixed-radix FFT, then n_fft whose FFT size has a prime
# factor above 7, which it takes on the direct DFT
FFT_GEOMETRIES = ((16000, 400, 100, 80, 8000.0), (22050, 1000, 250, 80, 8000.0),
                  (8000, 128, 32, 40, None), (22050, 8192, 2048, 80, None),
                  (16000, 300, 100, 80, 8000.0), (16000, 375, 125, 80, 8000.0))
DIRECT_GEOMETRIES = ((16000, 802, 401, 80, 8000.0), (44100, 1102, 551, 80, 8000.0))
ENH_BATCH, ENH_SEG = 8, 32768     # the VoiceBank recipe's defaults (examples/voice_bank.py)
ENH_RT_TOL = 1e-4                 # enhance with an identity mask vs its input, away from the edges
PQMF_TOL = 1e-5                   # PQMF card vs CPU, ratio to max abs (tests/test_dsp.py:197)
ENH_LOSSES = ('loss', 'mag_l1', 'log_l1')


def direct_work(b, t, frames, n_fft, f_used, nnz, n_mels):
    """(fp32 FLOPs, fp64 FLOPs, bytes) of the direct DFT K2's direct path
    runs on b items of t samples, ``frames`` frames each: 2 FMAs per sample,
    used bin and frame in fp64, the band mel in fp32 (2 per nonzero of the
    filterbank); the waveform read and the log-mel written once. Kept as
    ``dft_bound_ms`` beside the bound of the function (an FFT's work)."""
    n = b * frames
    return 2.0 * nnz * n, 4.0 * f_used * n_fft * n, 4.0 * (b * t + n_mels * n)


def direct_bwd_work(b, t, frames, n_fft, hop, f_used, nnz, n_mels):
    """(fp32 FLOPs, fp64 FLOPs, bytes) of the work K4's backward runs on the
    direct path: the forward's DFT and band mel recomputed, dmag (2 per
    nonzero), the bins' gradients (~12 per used bin), the adjoint DFT (2
    FMAs per sample, used bin and frame), the window, and the overlap-add
    (n_fft / hop adds per sample); the waveform and the mel's gradient read
    and the waveform's gradient written once. Kept as
    ``direct_bwd_dft_bound_ms`` beside the bound of the function
    (:func:`logmel_bwd_work`, an inverse FFT's work)."""
    n = b * frames
    fp64 = (8.0 * f_used * n_fft + 2.0 * nnz + 12.0 * f_used + n_fft) * n \
        + (n_fft // hop) * b * t
    return 2.0 * nnz * n, fp64, 4.0 * (2 * b * t + n_mels * n)


def voice_bank_tree(work):
    """Phase 12's VoiceBank tree under ``work`` (tones plus white noise, as
    tests/test_e2e_voicebank.py:27-48: 2 x 24 training and 8 validation
    int16 pairs of 2.5-3.5 s) and its metas: (meta dir, wav bytes, seconds
    of make_meta)."""
    import random
    from pytorch_sound_tpu_torch.data.meta.voice_bank import VoiceBankMeta
    from pytorch_sound_tpu_torch.utils.wavio import write_wav
    vrng = np.random.default_rng(12)
    raw = os.path.join(work, 'raw')
    os.makedirs(os.path.join(raw, 'txt'))
    n_bytes = 0
    for phase, speakers in (('trainset', ('p280', 'p282')), ('validset', ('p281',))):
        for kind in ('clean', 'noisy'):
            os.makedirs(os.path.join(raw, '%s_%s_wav' % (phase, kind)))
        for spk in speakers:
            for u in range(24 if phase == 'trainset' else 8):
                key = '%s_%03d' % (spk, u)
                n = int(SR * vrng.uniform(2.5, 3.5))
                tt = np.arange(n) / SR
                clean = 0.3 * np.sin(2 * np.pi * vrng.uniform(100, 400) * tt)
                noisy = clean + 0.1 * vrng.standard_normal(n)
                for kind, sig in (('clean', clean), ('noisy', noisy)):
                    path = os.path.join(raw, '%s_%s_wav' % (phase, kind), key + '.wav')
                    write_wav(path, np.clip(sig, -1, 1).astype(np.float32), SR,
                              dtype='int16')
                    n_bytes += os.path.getsize(path)
                with open(os.path.join(raw, 'txt', key + '.txt'), 'w') as f:
                    f.write('synthetic utterance %d.' % u)
    meta = os.path.join(work, 'meta')
    random.seed(0)
    t0 = time.perf_counter()
    VoiceBankMeta(meta).make_meta(raw, 2, 15, 0)
    return meta, n_bytes, time.perf_counter() - t0


def dsp_path(dev, card, rng):
    """Phase 12: K2 at the n_fft off the powers of two, on its mixed-radix
    FFT and on its direct DFT (and K4's backward on both), the transforms'
    main path on K2, the VoiceBank recipe from disk, and enhance. Returns
    the main path's K2 launches on the FFT (those on the direct DFT are the
    ``logmel_direct`` entry's), the ``logmel`` entry's keys for 400 / 100,
    the JSON entry of K2's direct DFT and the keys of K4's entry for 400 /
    100."""
    import copy
    import torch
    from pytorch_sound_tpu_torch.data.meta.voice_bank import VoiceBankMeta, get_datasets
    from pytorch_sound_tpu_torch.examples import voice_bank as vb
    from pytorch_sound_tpu_torch.models import build_model, transforms as T
    from pytorch_sound_tpu_torch.ops import mel as mel_ops, pqmf as pqmf_ops
    from pytorch_sound_tpu_torch.ops import sound as sound_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    from pytorch_sound_tpu_torch.trainer import adam
    from pytorch_sound_tpu_torch.utils.commons import LOGGER

    # 12a. K2 at n_fft that are not powers of two, on the mixed-radix FFT,
    #      and at n_fft it takes on the direct DFT: both conventions, noise
    #      and tones, against the plain version in fp64, one launch each on
    #      the path the geometry must take, reruns bit-identical
    worst = worst_direct = 0.0
    for sr, n_fft, hop, n_mels, fmax in FFT_GEOMETRIES + DIRECT_GEOMETRIES:
        direct = (sr, n_fft, hop, n_mels, fmax) in DIRECT_GEOMETRIES
        assert lm.fft_path(n_fft) != direct, n_fft
        filt = mel_ops.cached_mel_filter(sr, n_fft, n_mels, 0.0, fmax)
        lo, hi = mel_ops.db_to_log(-100.0), mel_ops.db_to_log(20.0)
        hpad = (n_fft - hop) // 2
        conventions = {
            'centered': (dict(min_db=-100.0, max_db=20.0), dict(pad=n_fft // 2, lo=lo, hi=hi)),
            'hifigan': (dict(pad=hpad, power_eps=1e-9, log_floor=1e-5),
                        dict(pad=hpad, power_eps=1e-9, log_floor=1e-5))}
        t = 3 * sr + 17
        for kind, wav in (('noise', rng.standard_normal((4, t)) * 0.2),
                          ('tones', tones(rng, 4, t, am=False))):
            x = torch.from_numpy(wav.astype(np.float32)).to(dev)
            for conv, (kw, plain_kw) in conventions.items():
                before = (lm.fused_log_mel.launches, lm.fused_log_mel.direct_launches)
                ker = lm.fused_log_mel(x, sr, n_mels, n_fft, n_fft, hop, mel_max=fmax, **kw)
                launched = (lm.fused_log_mel.launches - before[0],
                            lm.fused_log_mel.direct_launches - before[1])
                rerun = torch.equal(ker, lm.fused_log_mel(x, sr, n_mels, n_fft, n_fft, hop,
                                                          mel_max=fmax, **kw))
                ref64 = mel_ops.log_mel(x.double(), filt, n_fft, hop, n_fft, **plain_kw)
                torch.cuda.synchronize()
                err = max_err(ker.double(), ref64)
                if direct:
                    worst_direct = max(worst_direct, err)
                else:
                    worst = max(worst, err)
                log('k2_path', n_fft=n_fft, hop=hop, sr=sr, path='direct' if direct else 'fft',
                    convention=conv, signal=kind, shape=tuple(ker.shape),
                    launches='%d/%d' % launched, vs_fp64='%.3g' % err,
                    rerun_bit_identical=rerun)
                assert ker.shape == ref64.shape and launched == (1, int(direct)), (n_fft, launched)
                assert err <= MEL_TOL and rerun, (n_fft, conv, kind, err, rerun)

    #     K4's backward at 16 kHz, 400 / 100 (the mixed-radix FFT) and at
    #     802 / 401 (the direct DFT) against autograd of the plain version in
    #     fp64 on noise and tones, and of the fp32 plain version on noise,
    #     each relative to its largest entry (on tones the fp32 plain version
    #     is itself ~1e-3 off fp64 there: the gradient reaches ~1e3 through
    #     1 / mel in quiet bands)
    def k4_geom(n_fft, hop):
        return dict(sampling_rate=16000, n_fft=n_fft, window_size=n_fft, hop_size=hop,
                    num_mels=80, fmax=8000.0)

    def k4_mel(x, n_fft=400, hop=100):
        return lm.fused_log_mel(x, 16000, 80, n_fft, n_fft, hop, mel_max=8000.0,
                                pad=(n_fft - hop) // 2, power_eps=1e-9, log_floor=1e-5)

    bwd_err, bwd_rel = {}, {}
    for n_fft, hop in ((400, 100), (802, 401)):
        geom = k4_geom(n_fft, hop)
        for kind, wav in (('noise', rng.standard_normal((4, 3 * 16000)) * 0.2),
                          ('tones', tones(rng, 4, 3 * 16000, am=False))):
            x = torch.from_numpy(wav.astype(np.float32)).to(dev)
            cot = torch.cos(k4_mel(x, n_fft, hop))
            before = lm.fused_hifigan_mel_trainable.bwd_launches
            got = lm.hifigan_mel_backward(x, cot, **geom)
            launched = lm.fused_hifigan_mel_trainable.bwd_launches - before
            rerun = torch.equal(got, lm.hifigan_mel_backward(x, cot, **geom))
            ref = lm.hifigan_mel_vjp(x, cot, **geom)
            ref64 = lm.hifigan_mel_vjp(x.double(), cot.double(), **geom)
            torch.cuda.synchronize()
            err = max_err(got, ref) / float(ref.abs().max())
            rel64 = max_err(got.double(), ref64) / float(ref64.abs().max())
            bwd_rel[n_fft] = max(bwd_rel.get(n_fft, 0.0), rel64)
            if kind == 'noise':
                bwd_err[n_fft] = err
            log('k4_bwd', geometry='16k_%d_%d' % (n_fft, hop),
                path='fft' if lm.fft_path(n_fft) else 'direct', signal=kind,
                launches=launched, vs_plain_rel='%.3g' % err, vs_fp64_rel='%.3g' % rel64,
                grad_max='%.3g' % float(ref.abs().max()), rerun_bit_identical=rerun)
            assert launched == 1 and rerun and rel64 <= GRAD_TOL, (kind, launched, rerun, rel64)
            assert kind == 'tones' or err <= GRAD_TOL, (kind, err)

    #     the main path: LogMelSpectrogram at the settings' geometry on (N, T)
    #     and (N, 1, T), MFCC on (N, 1, T), LogMelSpectrogram at 16 kHz, 400 /
    #     100 on (N, 1, T) (the mixed-radix FFT); counters from zero, and no
    #     launch on the direct DFT
    settings_args = (SR, 80, 1024, 1024, 256, -50, 30, 0, 8000)
    wav8 = torch.from_numpy(tones(rng, ENH_BATCH, ENH_SEG)).to(dev)
    wav16 = torch.from_numpy(tones(rng, 16, 4 * 16000)).to(dev)
    speech16 = (16000, 80, 400, 400, 100, -50, 30, 0, 8000)
    lm.fused_log_mel.launches = lm.fused_log_mel.direct_launches = 0
    lms = T.LogMelSpectrogram(*settings_args)
    mel2, mel3 = lms(wav8), lms(wav8[:, None])
    mfcc = T.MFCC(SR, 80, 1024, 1024, 40, 256, -50, 30, 0, 8000)(wav8[:, None])
    mel16 = T.LogMelSpectrogram(*speech16)(wav16[:, None])
    torch.cuda.synchronize()
    main_launches = (lm.fused_log_mel.launches, lm.fused_log_mel.direct_launches)
    err2 = max_err(mel2.double(), mel_ops.log_mel_spectrogram(wav8.double(), *settings_args))
    err16 = max_err(mel16[:, 0].double(), mel_ops.log_mel_spectrogram(wav16.double(), *speech16))
    mfcc_err = max_err(mfcc, mel_ops.mel_to_mfcc(mel3, 40, 80))
    log('counts', what='transforms', logmel=main_launches[0], logmel_direct=main_launches[1],
        settings_vs_fp64='%.3g' % err2, speech16k_vs_fp64='%.3g' % err16,
        rank3_bit_identical=torch.equal(mel3[:, 0], mel2), mfcc_vs_dct='%.3g' % mfcc_err,
        shapes='%s/%s/%s/%s' % (tuple(mel2.shape), tuple(mel3.shape), tuple(mfcc.shape),
                                tuple(mel16.shape)))
    assert main_launches == (4, 0), main_launches
    assert mel3.shape == (ENH_BATCH, 1, 80, ENH_SEG // 256 + 1) and torch.equal(mel3[:, 0], mel2)
    assert mfcc.shape == (ENH_BATCH, 1, 40, ENH_SEG // 256 + 1) and mfcc_err <= 1e-5
    assert mel16.shape == (16, 1, 80, 641)
    assert max(err2, err16) <= MEL_TOL, (err2, err16)
    worst = max(worst, err2, err16)
    #     the kernel has no gradient and takes float32: the transform raises
    #     on the card where the CPU's plain version would differentiate or
    #     run in float64
    for arg, error in ((wav8.clone().requires_grad_(True), RuntimeError),
                       (wav8.double(), ValueError)):
        try:
            lms(arg)
        except error:
            continue
        raise AssertionError('LogMelSpectrogram took %s input that requires grad %s on the card'
                             % (arg.dtype, arg.requires_grad))

    #     timings at 16 kHz, 400 / 100, 16 x 4 s: K2 (LogMelSpectrogram's
    #     geometry) and K4's backward (the HiFi-GAN convention) on the
    #     mixed-radix FFT against their plain versions and, in turns with
    #     them, on the direct DFT (_direct_log_mel, _direct_backward)
    c = lm._constants(16000, 400, 400, 80, 0.0, 8000.0, str(dev))
    f_used, nnz = c.mel_w.shape[1], int((c.mel_w != 0).sum())
    x16 = wav16
    with torch.inference_mode():
        k_ms, p_ms, k_runs, p_runs = paired_ms(
            lambda: mel_ops.log_mel_spectrogram(x16, *speech16),
            lambda: lm.fused_log_mel(x16, 16000, 80, 400, 400, 100, -50, 30, 0, 8000), 20)
        d_ms, k2_ms, d_runs, k2_runs = paired_ms(
            lambda: lm.fused_log_mel(x16, 16000, 80, 400, 400, 100, -50, 30, 0, 8000),
            lambda: lm._direct_log_mel(x16, 16000, 80, 400, 400, 100, -50, 30, 0, 8000), 20)
    frames = 1 + x16.shape[1] // 100
    k_bound, k_bound_by = bound(2.0 * nnz * 16 * frames, fft_flops(400, f_used) * 16 * frames,
                                4.0 * (x16.numel() + 16 * 80 * frames),
                                fp64_peak=PEAK_FP64_CUDA_CORES)
    dft_bound, _ = bound(*direct_work(16, x16.shape[1], frames, 400, f_used, nnz, 80),
                         fp64_peak=PEAK_FP64_CUDA_CORES)
    cot16 = torch.cos(k4_mel(x16))
    geom = k4_geom(400, 100)
    b_ms, bp_ms, b_runs, bp_runs = paired_ms(
        lambda: lm.hifigan_mel_vjp(x16, cot16, **geom),
        lambda: lm.hifigan_mel_backward(x16, cot16, **geom), 10)
    bd_ms, b2_ms, bd_runs, b2_runs = paired_ms(
        lambda: lm.hifigan_mel_backward(x16, cot16, **geom),
        lambda: lm._direct_backward(x16, cot16, **geom), 10)
    bframes = cot16.shape[-1]
    assert bframes == logmel_frames(x16.shape[1], 400, 100), bframes
    b_bound, b_bound_by = bound(*logmel_bwd_work(16, x16.shape[1], f_used, nnz, 80, 400, 100),
                                fp64_peak=PEAK_FP64_CUDA_CORES)
    b_dft_bound, _ = bound(*direct_bwd_work(16, x16.shape[1], bframes, 400, 100, f_used,
                                            nnz, 80), fp64_peak=PEAK_FP64_CUDA_CORES)
    log('time', card=repr(card), what='k2_16x4s_16k_400_100', fft_kernel_ms='%.4f' % k_ms,
        plain_ms='%.4f' % p_ms, fft_kernel_runs='%.4f,%.4f' % k_runs,
        plain_runs='%.4f,%.4f' % p_runs, direct_kernel_ms='%.4f' % d_ms,
        direct_kernel_runs='%.4f,%.4f' % d_runs, fft_kernel_beside_direct_ms='%.4f' % k2_ms,
        fft_over_direct='%.2f' % (d_ms / k2_ms), bound_ms='%.5f' % k_bound,
        bound_by=k_bound_by, fft_share_of_bound='%.4f' % (k_bound / k_ms),
        dft_bound_ms='%.5f' % dft_bound)
    log('time', card=repr(card), what='k4_bwd_16x4s_16k_400_100', fft_kernels_ms='%.4f' % b_ms,
        plain_vjp_ms='%.4f' % bp_ms, fft_runs='%.4f,%.4f' % b_runs,
        plain_vjp_runs='%.4f,%.4f' % bp_runs, direct_kernels_ms='%.4f' % bd_ms,
        direct_runs='%.4f,%.4f' % bd_runs, fft_beside_direct_ms='%.4f' % b2_ms,
        bound_ms='%.5f' % b_bound, bound_by=b_bound_by,
        fft_share_of_bound='%.4f' % (b_bound / b_ms), dft_bound_ms='%.5f' % b_dft_bound)
    k2_speech = {'speech16k_ms': k_ms, 'speech16k_plain_ms': p_ms,
                 'speech16k_bound_ms': k_bound, 'speech16k_bound_by': k_bound_by,
                 'speech16k_max_abs_err': worst}
    entry = {'name': 'logmel_direct', 'route': 'cuda', 'source': lm.SOURCE,
             'replaces': 'pytorch_sound_tpu/ops/pallas/logmel.py:157',
             'launches': main_launches[1], 'max_abs_err': worst_direct, 'ms': d_ms,
             'plain_ms': p_ms, 'bound_ms': k_bound, 'bound_by': k_bound_by,
             'dft_bound_ms': dft_bound, 'shape': '16x64000_16k_400_100_forced_direct',
             'library_ms': None}
    k4_speech = {'speech16k_bwd_ms': b_ms, 'speech16k_plain_vjp_ms': bp_ms,
                 'speech16k_bwd_bound_ms': b_bound, 'speech16k_bwd_bound_by': b_bound_by,
                 'speech16k_bwd_rel_err': bwd_err[400],
                 'speech16k_bwd_fp64_rel_err': bwd_rel[400],
                 'direct_bwd_ms': bd_ms, 'direct_bwd_dft_bound_ms': b_dft_bound,
                 'direct_bwd_802_rel_err': bwd_err[802],
                 'direct_bwd_802_fp64_rel_err': bwd_rel[802]}

    # 12b. the recipe from disk: a VoiceBank tree (tones plus white noise, as
    #      tests/test_e2e_voicebank.py:27-48), its metas, the loader alone,
    #      main() with spec_masker_base at 8 x 32768 for 6 steps, and 3 steps
    #      plus a resume to 6 whose step-6 checkpoint equals the first run's
    deterministic = torch.backends.cudnn.deterministic
    work = tempfile.mkdtemp(prefix='chip_smoke_vb_')
    try:
        meta, n_bytes, meta_s = voice_bank_tree(work)
        rows = [len(VoiceBankMeta(os.path.join(meta, name))) for name in META_FILES]
        log('meta', what='voice_bank', wav_mb='%.1f' % (n_bytes / 1e6),
            rows='/'.join(map(str, rows)), seconds='%.3f' % meta_s)
        assert rows == [56, 48, 8], rows

        loader_ms = {0: [], 2: []}
        for workers in (0, 0, 2, 2, 0):
            train, _ = get_datasets(meta, ENH_BATCH, workers, fix_len=ENH_SEG,
                                    pad_multiple=ENH_SEG)
            t0 = time.perf_counter()
            batches = list(train)
            loader_ms[workers].append((time.perf_counter() - t0) / len(batches) * 1e3)
            assert len(batches) == 6 and batches[0][0].shape == (ENH_BATCH, ENH_SEG)
        loader_ms[0].pop(0)

        def run_main(save_dir, max_step):
            lines = LogLines()
            LOGGER.addHandler(lines)
            np.random.seed(0)
            torch.manual_seed(0)
            try:
                best = vb.main(meta, save_dir, batch_size=ENH_BATCH, num_workers=0,
                               fix_len=ENH_SEG, max_step=max_step, valid_max_step=1,
                               save_interval=3, log_interval=1, device=str(dev))
                torch.cuda.synchronize()
            finally:
                LOGGER.removeHandler(lines)
            return (best, *lines.train_steps())

        torch.backends.cudnn.deterministic = True
        save_a, save_b = os.path.join(work, 'save_a'), os.path.join(work, 'save_b')
        t0 = time.perf_counter()
        best, steps, times = run_main(save_a, 6)
        main_s = time.perf_counter() - t0
        for s_ in sorted(steps):
            log('train', route='voice_bank', step=s_,
                **{k: '%.6f' % steps[s_][k] for k in ENH_LOSSES})
        assert sorted(steps) == list(range(1, 7)), sorted(steps)
        assert all(np.isfinite(m[k]) for m in steps.values() for k in ENH_LOSSES), steps
        assert np.isfinite(best), best
        ckpt = os.path.join(save_a, 'models', 'voice_bank', 'SpectrogramMaskNet')
        assert sorted(os.listdir(ckpt)) == ['step_000003.chkpt', 'step_000006.chkpt']
        wall = [(times[i + 1] - times[i]) * 1e3 for i in (1, 2, 4, 5)]
        trainer_ms = 1e3 / steps[6]['steps_per_sec']
        run_main(save_b, 3)
        _, steps_b, _ = run_main(save_b, 6)
        states = [torch.load(os.path.join(d, 'models', 'voice_bank', 'SpectrogramMaskNet',
                                          'step_000006.chkpt'),
                             map_location='cpu', weights_only=True) for d in (save_a, save_b)]
        same = same_state(*states)
        log('resume', route='voice_bank', steps='4-6', logged=sorted(steps_b),
            checkpoint_bit_identical=same, seconds='%.1f' % main_s,
            best_valid_loss='%.6f' % best)
        assert sorted(steps_b) == [4, 5, 6] and same, (sorted(steps_b), same)
        torch.backends.cudnn.deterministic = deterministic

        #     the from-disk step at the trainer's prefetch_size 0 and 2 (its
        #     default), with 0 and 2 loader threads: wall ms between the
        #     train log lines of steps 3-10 (each step ends in the NaN
        #     guard's sync), in turns 0, 2, 2, 0
        def from_disk_ms(prefetch_size, workers):
            np.random.seed(0)
            torch.manual_seed(0)
            train, valid = get_datasets(meta, ENH_BATCH, workers, fix_len=ENH_SEG,
                                        pad_multiple=ENH_SEG)
            m = build_model('spec_masker_base')
            t = vb.VoiceBankTrainer(m, adam(m.parameters(), 2e-4), train, valid, max_step=10,
                                    valid_max_step=1, save_interval=10 ** 9, log_interval=1,
                                    save_dir=os.path.join(work, 'prefetch'), grad_norm=5.0,
                                    device=dev, prefetch_size=prefetch_size)
            lines = LogLines()
            LOGGER.addHandler(lines)
            try:
                t.run()
                torch.cuda.synchronize()
            finally:
                LOGGER.removeHandler(lines)
            _, times = lines.train_steps()
            return float(np.median([(times[i + 1] - times[i]) * 1e3 for i in range(3, 10)]))

        prefetch_ms = {}
        for workers in (0, 2):
            for size in (0, 2, 2, 0):
                prefetch_ms.setdefault((size, workers), []).append(from_disk_ms(size, workers))
        log('time', card=repr(card), what='voice_bank_from_disk_prefetch',
            **{'step_ms_prefetch%d_w%d' % k: '/'.join('%.2f' % x for x in v)
               for k, v in prefetch_ms.items()})

        #     one step on the card against the same step on the CPU, from the
        #     same weights (spec_masker_base from seed 0) and a batch of the
        #     loader; then the in-memory step time and peak memory
        torch.manual_seed(0)
        model = build_model('spec_masker_base')
        cpu_model = copy.deepcopy(model)
        noisy, clean = next(iter(get_datasets(meta, ENH_BATCH, 0, fix_len=ENH_SEG,
                                              pad_multiple=ENH_SEG)[0]))[:2]
        trainers, results = [], []
        for device, m in ((dev, model), ('cpu', cpu_model)):
            t = vb.VoiceBankTrainer(m, adam(m.parameters(), 2e-4), None, None, max_step=1,
                                    valid_max_step=1, save_interval=10 ** 9,
                                    log_interval=10 ** 9, save_dir=os.path.join(work, 'step'),
                                    grad_norm=5.0, seed=1, device=device)
            loss, meta_ = t._train_step(t.to_device([noisy, clean]), is_logging=True)
            results.append(({k: float(meta_[k][0].detach()) for k in ENH_LOSSES},
                            {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()}))
            trainers.append(t)
        (card_l, card_g), (cpu_l, cpu_g) = results
        loss_rel = max(abs(card_l[k] - cpu_l[k]) / abs(cpu_l[k]) for k in ENH_LOSSES)
        grad_rel, worst_grad = max((float((card_g[k] - g).norm()) / max(float(g.norm()), 1e-30),
                                    k) for k, g in cpu_g.items())
        log('card_cpu', route='voice_bank', losses=card_l, worst_loss_rel='%.3g' % loss_rel,
            worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst_grad,
            params=sum(p.numel() for p in model.parameters()))
        assert loss_rel <= CARD_CPU_RTOL and grad_rel <= CARD_CPU_GRAD_TOL, \
            (loss_rel, grad_rel, worst_grad)

        t = trainers[0]
        batch = t.to_device([noisy, clean])
        for _ in range(3):
            t._train_step(batch, is_logging=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        step_ms = []
        for _ in range(10):
            t0 = time.perf_counter()
            t._train_step(batch, is_logging=False)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        # 12c. enhance at 8 x 32768: against the CPU from the same weights, an
        #      identity mask's round trip, its time; multi_stft_loss and the
        #      PQMF round trip on the card against the CPU
        model.eval()
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        noisy_d = batch[0]
        out = vb.enhance(model, noisy_d)
        cpu_out = vb.enhance(cpu_model, noisy_d.cpu())
        ident = vb.enhance(torch.ones_like, noisy_d)
        torch.cuda.synchronize()
        enh_rel = max_err(out.cpu(), cpu_out) / float(cpu_out.abs().max())
        rt_err = max_err(ident[:, 512:-512], noisy_d[:, 512:-512])
        enh_ms = cuda_ms(lambda: vb.enhance(model, noisy_d), 10)
        params = [(1024, 1024, 256), (2048, 2048, 512), (512, 512, 128)]
        loss_d = sound_ops.multi_stft_loss(out, batch[1], params)
        loss_c = sound_ops.multi_stft_loss(out.cpu(), batch[1].cpu(), params)
        msl_rel = max(abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(loss_d, loss_c))
        sig = torch.from_numpy(tones(rng, ENH_BATCH, ENH_SEG)).to(dev)[:, None]
        bands = pqmf_ops.analysis(sig)
        rec = pqmf_ops.synthesis(bands)
        rec_c = pqmf_ops.synthesis(pqmf_ops.analysis(sig.cpu()))
        torch.cuda.synchronize()
        pqmf_rel = max_err(rec.cpu(), rec_c) / float(rec_c.abs().max())
        corr = min(float(np.corrcoef(r[0, 1:-1000], s[0, :-1001])[0, 1])
                   for r, s in zip(rec.cpu().numpy(), sig.cpu().numpy()))
        pqmf_ms = cuda_ms(lambda: pqmf_ops.synthesis(pqmf_ops.analysis(sig)), 10)
        log('enhance', shape=tuple(out.shape), card_vs_cpu_rel='%.3g' % enh_rel,
            identity_round_trip='%.3g' % rt_err, multi_stft_loss=[float(v) for v in loss_d],
            multi_stft_loss_card_vs_cpu_rel='%.3g' % msl_rel, pqmf_bands=tuple(bands.shape),
            pqmf_card_vs_cpu_rel='%.3g' % pqmf_rel, pqmf_round_trip_corr='%.5f' % corr)
        assert out.shape == noisy_d.shape and bool(torch.isfinite(out).all())
        assert enh_rel <= CARD_CPU_RTOL and rt_err <= ENH_RT_TOL, (enh_rel, rt_err)
        assert msl_rel <= CARD_CPU_RTOL and pqmf_rel <= PQMF_TOL and corr > 0.98, \
            (msl_rel, pqmf_rel, corr)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(work, ignore_errors=True)

    log('time', card=repr(card), what='voice_bank_8x32768', make_meta_s='%.3f' % meta_s,
        loader_ms_per_batch_w0='/'.join('%.2f' % x for x in loader_ms[0]),
        loader_ms_per_batch_w2='/'.join('%.2f' % x for x in loader_ms[2]),
        main_step_wall_ms='/'.join('%.2f' % x for x in wall),
        main_trainer_step_ms='%.2f' % trainer_ms,
        in_memory_step_ms='%.3f' % float(np.median(step_ms)),
        in_memory_step_ms_range='%.3f-%.3f' % (min(step_ms), max(step_ms)),
        peak_memory_gb='%.3f' % peak_gb, enhance_ms='%.4f' % enh_ms,
        pqmf_round_trip_ms='%.4f' % pqmf_ms)
    return main_launches[0] - main_launches[1], k2_speech, entry, k4_speech


FEATURE_SRS = {48000: 192, 44100: 16, 22050: 16}   # phase 13: files per source rate


def speech_like(rng, n, sr):
    """A voiced-speech stand-in at ``sr``: a 100-300 Hz harmonic series
    with a slow pitch glide and a syllable-rate envelope, light noise."""
    t = np.arange(n) / sr
    f0 = rng.uniform(100.0, 300.0) * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    wav = sum(0.5 / h * np.sin(h * phase) for h in (1, 2, 3, 4))
    wav = wav * (0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(2.5, 5.0) * t)) \
        + 0.01 * rng.standard_normal(n)
    return (0.5 * wav / np.abs(wav).max()).astype(np.float32)


def feature_path(dev, card):
    """Phase 13: feature extraction (``scripts.preprocess.Processor.
    extract_features``) on the card from a VCTK-shaped tree under $TMPDIR:
    the native runtime built from its source and its int16 loader against
    the WAV reader; the resampler on the card against the native one and the
    CPU, with TF32 off and on; the pipeline at the JAX defaults, at batch 64
    on the f32 wire at stages 2 and 3, and on the host-resampled wires at
    int8, each against the CPU run of the same call, with K2's launches per
    batch, K2 against its plain version on the batches' own card tensors,
    and the timings. Returns (K2's main-path launches, K2's fields at the
    pipeline's shape)."""
    import torch
    from pytorch_sound_tpu_torch import native, settings
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    from pytorch_sound_tpu_torch.ops.resample import resample_out_len, resample_poly
    from pytorch_sound_tpu_torch.parallel import PinnedCopier
    from pytorch_sound_tpu_torch.scripts import preprocess as pre
    from pytorch_sound_tpu_torch.utils import wavio

    hop = settings.HOP_LENGTH
    mel_args = (SR, settings.MEL_SIZE, settings.N_FFT, settings.WIN_LENGTH, hop,
                settings.MIN_DB, settings.MAX_DB, settings.MEL_MIN, settings.MEL_MAX)
    work = tempfile.mkdtemp(prefix='chip_smoke_features_')
    launches = 0
    try:
        # 13.0 the tree: 4 speakers x 48 speech-like utterances of 1.5-9 s at
        #      48 kHz, 16 files of white noise at 44.1 kHz and 16 speech-like
        #      at 22.05 kHz (no resample), 2 stereo files, 1 file with a
        #      header and no data (the decoder drops it)
        rng = np.random.default_rng(13)
        tree = os.path.join(work, 'in')
        info, n_bytes = {}, 0
        t0 = time.perf_counter()
        for sr, count in FEATURE_SRS.items():
            for i in range(count):
                spk = 'p%03d' % (225 + i // 48) if sr == 48000 else 'sr%d' % sr
                os.makedirs(os.path.join(tree, spk), exist_ok=True)
                name = '%s_%03d' % (spk, i % 48) if sr == 48000 else '%s_%02d' % (spk, i)
                path = os.path.join(tree, spk, name + '.wav')
                wavio.write_wav(path, speech_like(rng, int(sr * rng.uniform(1.5, 9.0)), sr), sr,
                                dtype='int16')
                info[name] = path
        for name in sorted(info):
            if name.startswith('sr44100'):       # tests/test_preprocess.py's signal
                n = wavio.read_wav_info(info[name])[1]
                wavio.write_wav(info[name], (0.1 * rng.standard_normal(n)).astype(np.float32),
                                44100, dtype='int16')
        for i in range(2):
            path = os.path.join(tree, 'p225', 'p225_stereo%d.wav' % i)
            n = int(48000 * rng.uniform(1.5, 9.0))
            wavio.write_wav(path, np.stack([speech_like(rng, n, 48000),
                                            speech_like(rng, n, 48000)]), 48000, dtype='int16')
            info['p225_stereo%d' % i] = path
        broken = os.path.join(tree, 'p226', 'p226_broken.wav')
        with open(broken, 'wb') as f:           # RIFF / fmt with no data chunk
            f.write(b'RIFF\x24\x00\x00\x00WAVEfmt \x10\x00\x00\x00\x01\x00\x01\x00'
                    b'\x80\xbb\x00\x00\x00\x77\x01\x00\x02\x00\x10\x00')
        n_bytes = sum(os.path.getsize(p) for p in list(info.values()) + [broken])
        heads = {name: wavio.read_wav_info(p) for name, p in info.items()}
        assert wavio.read_wav_info(broken)[:2] == (48000, 0)
        log('features', what='tree', files=len(info) + 1, mb='%.1f' % (n_bytes / 1e6),
            seconds='%.1f' % (time.perf_counter() - t0),
            rates='/'.join('%d:%d' % (sr, sum(h[0] == sr for h in heads.values()))
                           for sr in sorted(FEATURE_SRS)))
        assert len(info) == 226 and 100e6 < n_bytes < 130e6, (len(info), n_bytes)

        # 13.1 the native runtime, built from the port's source, and its int16
        #      loader against the WAV reader (stereo mixed down, quantised as
        #      the loader does) on every file; the broken one gives lens < 0
        t0 = time.perf_counter()
        lib_path = native.build()
        build_s = time.perf_counter() - t0
        names = sorted(info)
        pad = max(h[1] for h in heads.values())
        mat, lens, srs = native.batch_load_i16([info[n] for n in names] + [broken], pad)
        for i, name in enumerate(names):
            wav = wavio.load_wav(info[name])[0]
            want = np.clip(np.rint(wav.astype(np.float64) * 32768.0), -32768, 32767)
            assert lens[i] == len(wav) and srs[i] == heads[name][0], name
            assert np.array_equal(mat[i, :lens[i]], want.astype(np.int16)), name
            assert not mat[i, lens[i]:].any(), name
        log('features', what='native', library=os.path.relpath(lib_path),
            build_seconds='%.2f' % build_s, source=os.path.relpath(native.SOURCE),
            batch_load_i16_equals_read_wav=len(names), broken_len=int(lens[-1]))
        assert lens[-1] < 0 and lib_path.startswith(native.BUILD_DIR)
        del mat

        # 13.2 resample_poly on the card at 48 -> 22.05 and 44.1 -> 22.05 kHz,
        #      16 rows of 10 s, against the native resampler row by row and
        #      the CPU; again with TF32 turned on globally
        resampled = {}
        for sr in (48000, 44100):
            rows = [n for n in names if heads[n][0] == sr][:16]
            x, xl, _ = native.batch_load_i16([info[n] for n in rows], 10 * sr)
            xf = x.astype(np.float32) / 32768.0
            ref = np.stack([native.resample(r, sr, SR) for r in xf])
            cpu = resample_poly(torch.from_numpy(xf), sr, SR)
            xd = torch.from_numpy(xf).to(dev)
            flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                     torch.get_float32_matmul_precision())
            errs = {}
            try:
                for tf32 in (False, True):
                    torch.backends.cuda.matmul.allow_tf32 = tf32
                    torch.backends.cudnn.allow_tf32 = tf32
                    torch.set_float32_matmul_precision('high' if tf32 else 'highest')
                    got = resample_poly(xd, sr, SR).cpu()
                    errs[tf32] = (float(np.abs(got.numpy() - ref).max()),
                                  max_err(got, cpu), int((got.numpy() != ref).sum()))
                    resampled.setdefault(sr, got)
            finally:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags[:2]
                torch.set_float32_matmul_precision(flags[2])
            ms = cuda_ms(lambda: resample_poly(xd, sr, SR), 10)
            log('features', what='resample_%d' % sr, shape=tuple(xd.shape),
                out=tuple(resampled[sr].shape), vs_native='%.3g' % errs[False][0],
                vs_cpu='%.3g' % errs[False][1], differing_samples=errs[False][2],
                tf32_on_vs_native='%.3g' % errs[True][0], tf32_on_vs_cpu='%.3g' % errs[True][1],
                card=repr(card), ms='%.4f' % ms)
            assert resampled[sr].shape == (len(rows), resample_out_len(10 * sr, sr, SR))
            assert max(max(e[:2]) for e in errs.values()) <= 2e-6, errs

        # 13.3-13.5 the pipeline on the card and on the CPU. K2's counter from
        #      zero for each card run: one launch per batch, exactly
        def expected_batches(bs):
            groups = {}
            for h in heads.values():
                groups[h[0]] = groups.get(h[0], 0) + 1
            groups[48000] += 1                      # the broken file, dropped in its batch
            return sum(-(-n // bs) for n in groups.values())

        def run(tag, device, **kw):
            nonlocal launches
            out = os.path.join(work, tag)
            lm.fused_log_mel.launches = 0
            stats = pre.Processor.extract_features(tree, out, device=str(device), **kw)
            if str(device) != 'cpu':
                torch.cuda.synchronize()
                n = lm.fused_log_mel.launches
                launches += n
                want = expected_batches(kw.get('batch_size', 16))
                assert n == want == stats['batches'], (tag, n, want, stats['batches'])
            assert stats['utterances'] == len(names), (tag, stats['utterances'])
            assert sorted(os.listdir(out)) == sorted(n + '.mel.npy' for n in names), tag
            mels = {}
            for name in names:
                mel = np.load(os.path.join(out, name + '.mel.npy'))
                n = resample_out_len(*heads[name][1::-1], SR)
                assert mel.dtype == np.float32 and np.isfinite(mel).all(), (tag, name)
                assert mel.shape == (80, n // hop + 1), (tag, name, mel.shape)
                mels[name] = mel
            shutil.rmtree(out)
            return mels, stats

        cpu, cpu_stats = run('cpu_f32', 'cpu', batch_size=16, wire='f32')
        runs = {}
        #      first-use costs (K2's constants made on the host, the first
        #      launches of the program's kernels) out of the timed runs
        for wire in pre.WIRES:
            for x, sr in ((torch.zeros(2, 48000, dtype=torch.int16, device=dev), 48000),
                          (torch.full((2, 22050), 128, dtype=torch.uint8, device=dev), SR)):
                pre.feature_program(x, torch.full((2,), 20000, device=dev), sr, SR,
                                    'bf16x3', wire)
        torch.cuda.synchronize()

        #      13.3 the JAX defaults (batch 16, bf16, i16_src, stages 2): within
        #      one bf16 ulp of the CPU run's features (their bf16 rounding)
        runs['defaults'] = run('defaults', dev)
        ulps = 0.0
        for name in names:
            want = torch.from_numpy(cpu[name]).bfloat16().float().numpy()
            got = runs['defaults'][0][name]
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
            ulps = max(ulps, float((np.abs(got - want) / ulp).max()))
            assert np.array_equal(got, torch.from_numpy(got).bfloat16().float().numpy())
        log('features', what='defaults_b16_bf16', vs_cpu_max_bf16_ulps='%.3g' % ulps,
            k2_launches=runs['defaults'][1]['batches'])
        assert ulps <= 1.0, ulps

        #      13.4 batch 64, the f32 wire, stages 2 and 3: within MEL_TOL of
        #      the CPU run
        for stages in (2, 3):
            tag = 'b64_f32_s%d' % stages
            runs[tag] = run(tag, dev, batch_size=64, wire='f32', stages=stages)
            err = max(float(np.abs(runs[tag][0][n] - cpu[n]).max()) for n in names)
            log('features', what=tag, vs_cpu_max_abs='%.3g' % err,
                k2_launches=runs[tag][1]['batches'])
            assert err <= MEL_TOL, (tag, err)

        #      every batch of the 48 kHz group: the pipeline's K2 output (its
        #      f32 .npy) is K2 on that batch's card tensors, bit for bit, and
        #      within MEL_TOL of K2's plain version on them, run in fp64 (the
        #      kernel's DFT is fp64; the fp32 plain version carries ~4e-4 of
        #      rounding in the quiet bands of tonal input, printed beside)
        group = sorted(p for p in [info[n] for n in names] + [broken]
                       if wavio.read_wav_info(p)[0] == 48000)
        copier = PinnedCopier(dev)
        plain_err = plain32_err = 0.0
        batches_checked, y64 = 0, None
        with torch.inference_mode():
            for i in range(0, len(group), 64):
                mat, blens, bnames = pre.decode_batch(group[i:i + 64], 48000, SR, 10 * 48000)
                x, lengths = copier.take(copier.put([mat, np.asarray(blens, np.int64)]))
                y = pre.batch_audio(x, lengths, 48000, SR)
                ker = lm.fused_log_mel(y, *mel_args)
                plain = mel_ops.log_mel_spectrogram(y.double(), *mel_args)
                plain32 = mel_ops.log_mel_spectrogram(y, *mel_args)
                torch.cuda.synchronize()
                for j, (n, name) in enumerate(zip(blens, bnames)):
                    saved = torch.from_numpy(runs['b64_f32_s2'][0][name]).to(dev)
                    assert torch.equal(ker[j, :, :n // hop + 1], saved), name
                plain_err = max(plain_err, max_err(ker.double(), plain))
                plain32_err = max(plain32_err, max_err(ker, plain32))
                batches_checked += 1
                y64 = y if y64 is None else y64
        log('features', what='k2_vs_plain_48k_batches', batches=batches_checked,
            shape=tuple(y64.shape), vs_fp64_plain='%.3g' % plain_err,
            vs_fp32_plain='%.3g' % plain32_err)
        assert batches_checked == 4 and plain_err <= MEL_TOL, (batches_checked, plain_err)

        #      13.5 the host-resampled wires at int8, against the f32 i16_src
        #      run: at the JAX test's gates on its signal (the white-noise
        #      files at 44.1 kHz), plus one int8 step (range / 254); the
        #      speech-like files' deltas printed (mu-law's ~38 dB SNR lifts
        #      the quiet bands of tonal input); the card against the CPU run
        #      of the same call on the 44.1 kHz files, within one step
        noise = [n for n in names if heads[n][0] == 44100]
        for h2d, gate_max, gate_mean in (('i16_tgt', 0.05, None), ('mulaw8_tgt', 0.5, 0.02)):
            tag = '%s_int8' % h2d
            runs[tag] = run(tag, dev, batch_size=64, wire='int8', h2d=h2d)
            sub_out = os.path.join(work, tag + '_cpu')
            pre.Processor.extract_features(os.path.join(tree, 'sr44100'), sub_out, batch_size=64,
                                           wire='int8', h2d=h2d, device='cpu')
            worst = {True: [0.0, 0.0], False: [0.0, 0.0]}
            card_cpu_steps = 0.0
            for name in names:
                ref, got = runs['b64_f32_s2'][0][name], runs[tag][0][name]
                assert abs(ref.shape[1] - got.shape[1]) <= 1, (tag, name)
                t = min(ref.shape[1], got.shape[1]) - 2
                step = (ref.max() - ref.min()) / 254
                d = np.abs(got[:, :t] - ref[:, :t])
                w = worst[name in noise]
                w[0], w[1] = max(w[0], float(d.max() - step)), max(w[1], float(d.mean() - step))
                if name in noise:
                    cpu_mel = np.load(os.path.join(sub_out, name + '.mel.npy'))
                    cpu_step = (cpu_mel.max() - cpu_mel.min()) / 254
                    card_cpu_steps = max(card_cpu_steps,
                                         float(np.abs(got - cpu_mel).max() / cpu_step))
            log('features', what=tag, noise_max_abs_less_step='%.4f' % worst[True][0],
                noise_mean_abs_less_step='%.4f' % worst[True][1], gate_max=gate_max,
                gate_mean=gate_mean, speech_max_abs_less_step='%.4f' % worst[False][0],
                speech_mean_abs_less_step='%.4f' % worst[False][1],
                card_vs_cpu_int8_steps='%.3f' % card_cpu_steps,
                k2_launches=runs[tag][1]['batches'])
            assert worst[True][0] < gate_max and (gate_mean is None or worst[True][1] < gate_mean), \
                (tag, worst)
            assert card_cpu_steps <= 1.0 + 1e-3, (tag, card_cpu_steps)

        # 13.6 timings: utterances per second from the first decode to the
        #      last save; per batch medians of the host decode, the host's
        #      staging into pinned memory, the H2D copy, the batch program
        #      (CUDA events) and K2's share of it, the D2H copy, the save;
        #      the card's busy share
        k2_ms = cuda_ms(lambda: lm.fused_log_mel(y64, *mel_args), 10)
        k2_plain_ms = cuda_ms(lambda: mel_ops.log_mel_spectrogram(y64, *mel_args), 10)
        consts = lm._constants(SR, 1024, 1024, 80, 0.0, 8000.0, str(dev))
        f_used, nnz = consts.mel_w.shape[1], int((consts.mel_w != 0).sum())
        b, t = y64.shape
        frames = (1 + t // hop) * b
        k2_bound, k2_bound_by = bound(2.0 * nnz * frames, fft_flops(1024, f_used) * frames,
                                      4.0 * (b * t + 80 * frames),
                                      fp64_peak=PEAK_FP64_CUDA_CORES)
        med = {}
        for tag, (_, st) in runs.items():
            m = {k: float(np.median(st[k])) for k in ('decode_ms', 'stage_ms', 'h2d_ms',
                                                      'program_ms', 'd2h_ms', 'save_ms')}
            # the program's events also hold the host's launch gaps
            busy = sum(st['program_ms']) / (st['seconds'] * 1e3)
            copies = (sum(st['h2d_ms']) + sum(st['d2h_ms'])) / (st['seconds'] * 1e3)
            med[tag] = m
            log('time', card=repr(card), what='extract_features_' + tag,
                utt_per_s='%.1f' % (st['utterances'] / st['seconds']),
                seconds='%.3f' % st['seconds'], batches=st['batches'],
                **{k: '%.3f' % v for k, v in m.items()},
                card_busy_share='%.4f' % busy, copy_busy_share='%.4f' % copies)
        log('time', card=repr(card), what='extract_features_cpu_reference',
            utt_per_s='%.1f' % (cpu_stats['utterances'] / cpu_stats['seconds']),
            seconds='%.1f' % cpu_stats['seconds'])
        log('time', card=repr(card), what='k2_64x10s', kernel_ms='%.4f' % k2_ms,
            plain_ms='%.4f' % k2_plain_ms, bound_ms='%.5f' % k2_bound, bound_by=k2_bound_by,
            share_of_b64_program='%.3f' % (k2_ms / med['b64_f32_s2']['program_ms']))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return launches, {'extract_ms': k2_ms, 'extract_plain_ms': k2_plain_ms,
                      'extract_bound_ms': k2_bound, 'extract_shape': list(y64.shape)}


TTS_BATCH = 16                    # the LJSpeech recipe's batch (examples/ljspeech_tts.py:82)
TTS_PAD = 16384                   # its pad_multiple; the fixed batch pads to 8 x 16384
TTS_SYNTH_BATCH = 4
TTS_FRAMES = 400                  # synthesize's default max_frames: 399 frames decoded
TTS_LOSSES = ('loss', 'mel_l1', 'stop_bce')
TTS_STEP_TOL = 1e-4               # a synthesized frame vs decode_mel's column t on its
                                  # prefix, on the card and on the CPU (1e-5 CPU-only: cuBLAS
                                  # sums a 1-row and a T-row product apart). Free-running
                                  # card and CPU runs part: random weights amplify round-off
                                  # (fp32 vs fp64 on the CPU: 6e-7 at frame 10, 2e-3 at 100)
GL_TOL = 1e-6                     # Griffin-Lim in float64, card vs CPU, ratio to peak: on a
                                  # pseudo-inverse magnitude a 1e-14 change of the input moves
                                  # the output by 4.4e-9 (CPU), fp32 round-off by 0.2-0.3;
                                  # cuFFT vs MKL in float64 9.3e-8 (H100 80GB HBM3, 700 W)
WORDS = ('the', 'printer', 'of', 'a', 'book', 'was', 'in', 'every', 'sense', 'only',
         'which', 'we', 'are', 'at', 'present', 'concerned', 'differs', 'from', 'most',
         'if', 'not', 'all', 'arts', 'and', 'crafts', 'represented', 'exhibition', 'long',
         'time', 'ago', 'early', 'writers', 'made', 'their', 'letters', 'clear')


def tts_path(dev, card):
    """Phase 14: the text-to-speech family. An LJSpeech-shaped tree under
    $TMPDIR (100 speech-like int16 utterances of 2.1-9 s at 22.05 kHz, 16
    of them 5.3-5.9 s, and a metadata.csv of English sentences), the port's
    ``Processor.ljspeech``, then ``examples.ljspeech_tts.main`` with
    ``transformer_tts_base`` at batch 16 for 4 steps on the card with K2's
    launches counted (one per step, one per validation batch). On a fixed
    batch of 16 x 131072 samples from the tree (its wave masks): K2's
    targets against the plain log-mel in fp64, one step on the card against
    the CPU, three steps with ``remat=True`` against three without, the step
    time by CUDA events; a subprocess with the trainer's profiler window
    writes a trace, from which the card's busy share of two steps comes.
    Then ``synthesize`` at 4 x 400 with ``stop_threshold=1.0`` (399 frames),
    its frames against ``decode_mel``'s teacher-forced columns on the card
    and on the CPU, frames per second; ``InterfaceHifiGAN('hifi_gan_v2',
    device='cuda').decode`` of that mel (K1, each stage against its plain
    version on this input, card vs CPU; the mel head's bias at the
    targets' mean log-mel); Griffin-Lim (32 iterations, the
    zero phase) on one mel's pseudo-inverse magnitude, float64 card vs CPU,
    fp32 timed; the STFT's inputs shorter than one frame on cuFFT. Returns (K2 launches, K1 launches) of the main path."""
    import copy
    import random
    import torch
    from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader, SpeechDataset
    from pytorch_sound_tpu_torch.data.meta.ljspeech import LJSpeechMeta
    from pytorch_sound_tpu_torch.examples import ljspeech_tts as recipe
    from pytorch_sound_tpu_torch.interface.hifi_gan import InterfaceHifiGAN
    from pytorch_sound_tpu_torch.models import build_model
    from pytorch_sound_tpu_torch.models.tts import synthesize
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops import stft as stft_ops
    from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    from pytorch_sound_tpu_torch.ops.griffin_lim import griffin_lim
    from pytorch_sound_tpu_torch.scripts.preprocess import Processor
    from pytorch_sound_tpu_torch.trainer import adamw
    from pytorch_sound_tpu_torch.utils.commons import LOGGER
    from pytorch_sound_tpu_torch.utils.text import eng_t2i
    from pytorch_sound_tpu_torch import settings
    from pytorch_sound_tpu_torch.utils.wavio import write_wav

    mel_args = (settings.SAMPLE_RATE, settings.MEL_SIZE, settings.N_FFT, settings.WIN_LENGTH,
                settings.HOP_LENGTH, settings.MIN_DB, settings.MAX_DB, settings.MEL_MIN,
                settings.MEL_MAX)
    work = tempfile.mkdtemp(prefix='chip_smoke_tts_')
    try:
        # 14.1 the tree, its metas
        trng = np.random.default_rng(14)
        raw = os.path.join(work, 'raw')
        os.makedirs(os.path.join(raw, 'wavs'))
        seconds = np.concatenate([trng.uniform(2.1, 9.0, 84), trng.uniform(5.3, 5.9, 16)])
        rows, n_bytes = [], 0
        for u, sec in enumerate(seconds):
            key = 'LJ%03d-%04d' % (1 + u // 50, u % 50 + 1)
            path = os.path.join(raw, 'wavs', key + '.wav')
            write_wav(path, speech_like(trng, int(SR * sec), SR), SR, dtype='int16')
            n_bytes += os.path.getsize(path)
            words = trng.choice(WORDS, int(trng.integers(6, 20)))
            sentence = ' '.join(words).capitalize() + '.'
            rows.append('%s|%s|%s' % (key, sentence, sentence))
        with open(os.path.join(raw, 'metadata.csv'), 'w') as f:
            f.write('\n'.join(rows) + '\n')
        out = os.path.join(work, 'ljspeech')
        random.seed(0)
        t0 = time.perf_counter()
        Processor.ljspeech(raw, out, os.path.join(raw, 'metadata.csv'))
        prep_s = time.perf_counter() - t0
        meta_dir = os.path.join(out, 'meta')
        n_rows = [len(LJSpeechMeta(os.path.join(meta_dir, name))) for name in META_FILES]
        log('meta', what='ljspeech', wav_mb='%.1f' % (n_bytes / 1e6),
            rows='/'.join(map(str, n_rows)), preprocess_s='%.2f' % prep_s)
        assert n_rows == [100, 90, 10], n_rows

        # 14.2 main() at batch 16, 4 steps and a validation batch, K2 counted
        lines = LogLines()
        LOGGER.addHandler(lines)
        np.random.seed(0)
        torch.manual_seed(0)
        lm.fused_log_mel.launches = 0
        try:
            t0 = time.perf_counter()
            best = recipe.main(meta_dir, os.path.join(work, 'save'), batch_size=TTS_BATCH,
                               num_workers=0, max_step=4, valid_max_step=1, save_interval=4,
                               log_interval=1, device=str(dev))
            torch.cuda.synchronize()
            main_s = time.perf_counter() - t0
        finally:
            LOGGER.removeHandler(lines)
        k2_main = lm.fused_log_mel.launches
        steps, times = lines.train_steps()
        for s_ in sorted(steps):
            log('train', route='ljspeech_tts', step=s_,
                **{k: '%.6f' % steps[s_][k] for k in TTS_LOSSES})
        log('counts', route='ljspeech_tts', logmel=k2_main, steps=4, valid_batches=1,
            best_valid_loss='%.6f' % best, seconds='%.1f' % main_s)
        assert sorted(steps) == [1, 2, 3, 4] and np.isfinite(best), (sorted(steps), best)
        assert all(np.isfinite(m[k]) for m in steps.values() for k in TTS_LOSSES), steps
        assert k2_main == 4 + 1, k2_main
        ckpt = os.path.join(work, 'save', 'models', 'ljspeech_tts', 'TransformerTTS')
        assert os.listdir(ckpt) == ['step_000004.chkpt'], os.listdir(ckpt)

        # 14.3 a fixed batch of 16 x 131072 from the tree, with its masks
        meta = LJSpeechMeta(os.path.join(meta_dir, 'all_meta.json'))
        picks = [i for i, d in enumerate(meta.meta['duration']) if 5.3 <= d < 5.9][:TTS_BATCH]
        dataset = SpeechDataset(meta, audio_mask=True)
        batch = SpeechDataLoader.pad_collate_fn([dataset[i] for i in picks], TTS_PAD)
        assert batch[0].shape == (TTS_BATCH, 8 * TTS_PAD) and len(batch) == 3, \
            [b.shape for b in batch]
        wav_d = torch.from_numpy(batch[0]).to(dev)
        targets = recipe.LOG_MEL(wav_d)
        plain = mel_ops.log_mel_spectrogram(wav_d, *mel_args)
        plain64 = mel_ops.log_mel_spectrogram(wav_d.double(), *mel_args)
        torch.cuda.synchronize()
        k2_err = max_err(targets.double(), plain64)
        log('logmel', what='tts_targets_16x131072', shape=tuple(targets.shape),
            vs_fp64='%.3g' % k2_err, plain_fp32_vs_fp64='%.3g' % max_err(plain.double(), plain64))
        assert targets.shape == (TTS_BATCH, 80, 513) and k2_err <= MEL_TOL, \
            (targets.shape, k2_err)

        #      one step on the card against the same step on the CPU
        torch.manual_seed(0)
        model = build_model('transformer_tts_base')
        cpu_model = copy.deepcopy(model)
        results, trainers = [], []
        for device, m in ((dev, model), ('cpu', cpu_model)):
            t = recipe.TTSTrainer(m, adamw(m.parameters(), 1e-4, b1=0.9, b2=0.98), None, None,
                                  max_step=1, valid_max_step=1, save_interval=10 ** 9,
                                  log_interval=10 ** 9, save_dir=os.path.join(work, 'step'),
                                  grad_norm=1.0, seed=1, device=device)
            t.optimizer.zero_grad(set_to_none=True)
            loss, meta_ = t.forward(*t.to_device(batch), is_logging=True)
            loss.backward()
            results.append(({k: float(meta_[k][0].detach()) for k in TTS_LOSSES},
                            {k: p.grad.detach().cpu().double()
                             for k, p in m.named_parameters()}))
            trainers.append(t)
        (card_l, card_g), (cpu_l, cpu_g) = results
        loss_rel = max(abs(card_l[k] - cpu_l[k]) / abs(cpu_l[k]) for k in TTS_LOSSES)
        grad_rel, worst = max((float((card_g[k] - g).norm()) / max(float(g.norm()), 1e-30), k)
                              for k, g in cpu_g.items())
        log('card_cpu', route='ljspeech_tts', losses=card_l, worst_loss_rel='%.3g' % loss_rel,
            worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst,
            params=sum(p.numel() for p in model.parameters()))
        assert loss_rel <= CARD_CPU_RTOL and grad_rel <= CARD_CPU_GRAD_TOL, \
            (loss_rel, grad_rel, worst)

        #      three steps with remat against three without, from one state
        def three_steps(remat):
            torch.manual_seed(0)
            m = build_model('transformer_tts_base')
            t = recipe.TTSTrainer(m, adamw(m.parameters(), 1e-4, b1=0.9, b2=0.98), None, None,
                                  max_step=3, valid_max_step=1, save_interval=10 ** 9,
                                  log_interval=10 ** 9, save_dir=os.path.join(work, 'remat'),
                                  grad_norm=1.0, seed=1, device=dev, remat=remat)
            b = t.to_device(batch)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            losses = [float(t._train_step(b, is_logging=False)[0]) for _ in range(3)]
            return losses, torch.cuda.max_memory_allocated(dev) / 1e9, t

        plain_losses, plain_gb, step_trainer = three_steps(False)
        remat_losses, remat_gb, _ = three_steps(True)
        remat_rel = max(abs(a - b) / abs(b) for a, b in zip(remat_losses, plain_losses))
        log('remat', losses='/'.join('%.6f' % x for x in remat_losses),
            plain_losses='/'.join('%.6f' % x for x in plain_losses),
            worst_rel='%.3g' % remat_rel, peak_gb='%.3f' % remat_gb,
            plain_peak_gb='%.3f' % plain_gb)
        assert remat_rel <= RESUME_RTOL, (remat_losses, plain_losses)

        #      the step time by CUDA events, and the card's busy share from
        #      the trainer's profiler window, in a fresh process
        b = step_trainer.to_device(batch)
        step_ms = cuda_ms(lambda: step_trainer._train_step(b, is_logging=False), 10)
        prof = profile_steps([('ljspeech_tts', batch)], work)['ljspeech_tts']
        busy = prof['busy_share']
        log('profile', trace=os.path.basename(prof['trace']), kernels=prof['kernels'],
            logmel_kernels=prof['logmel_kernels'], window_ms='%.3f' % (prof['window_us'] / 1e3),
            busy_ms='%.3f' % (prof['busy_us'] / 1e3), device_busy_share='%.4f' % busy,
            top_ms_per_step=prof['top_ms_per_step'])
        assert prof['kernels'] > 0 and prof['logmel_kernels'] == prof['steps'], prof

        # 14.4 synthesis at 4 x 400 (stop_threshold 1.0: every frame runs)
        texts = [' '.join(trng.choice(WORDS, int(n))).capitalize() + '.'
                 for n in (18, 7, 12, 25)]
        ids = [eng_t2i(t) for t in texts]
        width = max(map(len, ids))
        ids = np.stack([np.pad(i, (0, width - len(i))) for i in ids])
        #      (the mel head's bias starts at the targets' mean, as a trained
        #      model's output sits in the log-mel range: from random weights
        #      alone the mel is ~N(0, 1), a loud white spectrum on which the
        #      fp32 v2 decode is ill-conditioned, 2.3e-4 from float64 on the
        #      CPU, the card 4.0e-4 on an H100 80GB HBM3 at 700 W)
        torch.manual_seed(1)
        tts = build_model('transformer_tts_base').eval()
        with torch.no_grad():
            tts.mel_head.bias.add_(float(targets.mean()))
        tts_cpu = copy.deepcopy(tts)
        tts.to(dev)
        synthesize(tts, ids, max_frames=8, stop_threshold=1.0)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = synthesize(tts, ids, max_frames=TTS_FRAMES, stop_threshold=1.0)
        torch.cuda.synchronize()
        synth_s = time.perf_counter() - t0
        frames = mel.shape[2]
        assert mel.shape == (TTS_SYNTH_BATCH, 80, TTS_FRAMES - 1), mel.shape
        with torch.no_grad():
            memory, pad_mask = tts.encode_text(torch.from_numpy(ids).to(dev))
            go = torch.full((TTS_SYNTH_BATCH, 80, 1), mel_ops.db_to_log(-50.0), device=dev)
            forced, _ = tts.decode_mel(memory, pad_mask, torch.cat([go, mel[:, :, :-1]], 2))
            #  the same columns from the CPU model on the card's frames
            cpu_memory, cpu_mask = tts_cpu.encode_text(torch.from_numpy(ids))
            cpu_forced, _ = tts_cpu.decode_mel(cpu_memory, cpu_mask,
                                               torch.cat([go, mel[:, :, :-1]], 2).cpu())
        cpu_mel = synthesize(tts_cpu, ids, max_frames=TTS_FRAMES, stop_threshold=1.0)
        step_err = max_err(forced, mel)
        forced_err = max_err(cpu_forced, mel.cpu())
        drift = (mel.cpu() - cpu_mel).abs().amax(dim=(0, 1))
        log('synth', shape=tuple(mel.shape), decode_step_vs_decode_mel='%.3g' % step_err,
            card_vs_cpu_teacher_forced='%.3g' % forced_err,
            free_running_card_vs_cpu='/'.join('%.2g' % float(drift[a:b].max())
                                              for a, b in ((0, 32), (32, 100), (100, 399))),
            mel_max='%.3f' % float(mel.abs().max()))
        assert bool(torch.isfinite(mel).all()) and step_err <= TTS_STEP_TOL, step_err
        assert forced_err <= TTS_STEP_TOL, forced_err

        # 14.5 the v2 decode of the synthesized mel: K1, each stage against
        #      its plain version on this input, card vs CPU; the kernel's,
        #      the card's plain and the CPU's decode beside the plain decode
        #      in float64
        iface = InterfaceHifiGAN('hifi_gan_v2', device='cuda')
        gen = iface.decoder
        gen64 = copy.deepcopy(gen).double()
        stage_err = []
        with torch.inference_mode():
            x, x64 = gen.conv_pre(mel), gen64.conv_pre(mel.double())
            for i in range(4):
                args = gen.stage_args(i)
                ref, ker = gs.generator_stage_reference(x, **args), gs.generator_stage(x, **args)
                stage_err.append(max_err(ker, ref))
                x = ref
                x64 = gs.generator_stage_reference(x64, **gen64.stage_args(i))
        gs.reset_launches()
        audio = iface.decode(mel)
        torch.cuda.synchronize()
        k1_main = gs.launch_count(gs.generator_stage)
        cpu_audio = InterfaceHifiGAN('hifi_gan_v2', device='cpu').decode(mel.cpu())
        dec_err = max_err(audio.cpu(), cpu_audio)
        decode_ms = cuda_ms(lambda: iface.decode(mel), 10)
        log('tts_decode', wav=tuple(audio.shape), launches=k1_main,
            stages_vs_plain='/'.join('%.3g' % e for e in stage_err),
            card_vs_cpu='%.3g' % dec_err, kernel_vs_fp64='%.3g' % max_err(audio.double(), x64),
            plain_vs_fp64='%.3g' % max_err(x.double(), x64),
            cpu_vs_fp64='%.3g' % max_err(cpu_audio.double(), x64.cpu()),
            mel_mean='%.3f' % float(mel.mean()), wav_max='%.4f' % float(audio.abs().max()))
        assert audio.shape == (TTS_SYNTH_BATCH, 1, frames * UP) and k1_main == 4, \
            (audio.shape, k1_main)
        assert max(stage_err) <= STAGE_TOL and dec_err <= DECODE_TOL, (stage_err, dec_err)

        # 14.6 Griffin-Lim (32 iterations, zero phase) on one mel's
        #      pseudo-inverse magnitude: float64 on the card against the CPU
        #      (in fp32 the near-zero bins of that magnitude leave the phase to
        #      round-off, which the momentum grows: fp32 is only logged)
        fb = mel_ops.cached_mel_filter(SR, settings.N_FFT, 80, 0.0, float(settings.MEL_MAX))
        mag = np.maximum(np.linalg.pinv(fb) @ np.exp(mel[0].double().cpu().numpy()), 0.0)[None]
        gl = {}
        for key, device, dtype in (('card64', dev, torch.float64), ('cpu64', 'cpu', torch.float64),
                                   ('card32', dev, torch.float32)):
            gl[key] = griffin_lim(torch.from_numpy(mag).to(device, dtype), settings.N_FFT,
                                  settings.HOP_LENGTH, settings.WIN_LENGTH, n_iter=32).cpu()
        inner = slice(settings.N_FFT, -settings.N_FFT)
        peak = float(gl['cpu64'][:, inner].abs().max())
        gl64_rel = max_err(gl['card64'][:, inner], gl['cpu64'][:, inner]) / peak
        gl32_rel = max_err(gl['card32'][:, inner].double(), gl['card64'][:, inner]) / peak
        mag32 = torch.from_numpy(mag).to(dev, torch.float32)
        gl_ms = cuda_ms(lambda: griffin_lim(mag32, settings.N_FFT, settings.HOP_LENGTH,
                                            settings.WIN_LENGTH, n_iter=32), 3)
        log('griffin_lim', wav=tuple(gl['card32'].shape), card64_vs_cpu64='%.3g' % gl64_rel,
            fp32_vs_fp64='%.3g' % gl32_rel)
        assert gl['card32'].shape == gl['card64'].shape == (1, (frames - 1) * settings.HOP_LENGTH)
        assert bool(torch.isfinite(gl['card32']).all()) and gl64_rel <= GL_TOL, gl64_rel

        # 14.7 inputs shorter than one frame on cuFFT: JAX's empty shapes
        x = torch.from_numpy(trng.standard_normal((2, 300)).astype(np.float32)).to(dev)
        shapes = {}
        for method in ('fft', 'matmul'):
            real, imag = stft_ops.stft(x, 512, 128, center=False, method=method)
            shapes['stft_' + method] = (tuple(real.shape), tuple(imag.shape))
            shapes['magnitude_' + method] = tuple(stft_ops.spectrogram_magnitude(
                x, 512, 128, center=False, method=method).shape)
            shapes['audio2mel_' + method] = tuple(mel_ops.audio2mel(x[:, :100],
                                                                     method=method).shape)
        full = stft_ops.stft(torch.cat([x, x], 1), 512, 128, center=False)[0]
        torch.cuda.synchronize()
        log('short_stft', **shapes, after=tuple(full.shape))
        for method in ('fft', 'matmul'):
            assert shapes['stft_' + method] == ((2, 257, 0), (2, 257, 0)), shapes
            assert shapes['magnitude_' + method] == (2, 257, 0), shapes
            assert shapes['audio2mel_' + method] == (2, 80, 0), shapes
        assert full.shape == (2, 257, 1) and bool(torch.isfinite(full).all())
    finally:
        shutil.rmtree(work, ignore_errors=True)

    main_wall = [(times[i + 1] - times[i]) * 1e3 for i in (1, 2, 3)]
    log('time', card=repr(card), what='tts_base_b16_ljspeech',
        main_step_wall_ms='/'.join('%.2f' % x for x in main_wall),
        step_ms_16x131072='%.3f' % step_ms, device_busy_share='%.4f' % busy,
        peak_memory_gb='%.3f' % plain_gb, remat_peak_memory_gb='%.3f' % remat_gb,
        preprocess_s='%.2f' % prep_s)
    log('time', card=repr(card), what='tts_synth_b4_400',
        synth_s='%.3f' % synth_s, frames_per_s='%.1f' % (TTS_SYNTH_BATCH * frames / synth_s),
        ms_per_step='%.3f' % (synth_s / frames * 1e3), v2_decode_ms='%.3f' % decode_ms,
        audio_s_per_s='%.1f' % (TTS_SYNTH_BATCH * frames * UP / SR
                                / (synth_s + decode_ms / 1e3)),
        griffin_lim_32_ms='%.3f' % gl_ms)
    return k2_main, k1_main


SEP_BATCH, SEP_SEG = 4, 65536     # the DSD100 recipe's defaults (examples/dsd100.py)
MAE_BATCH, MAE_SEG = 4, 131072    # the Maestro recipe's (examples/maestro.py): 513 mel frames
MAE_SR = 44100
SEP_LOSSES = ('loss', 'voice_l1', 'background_l1')
MAE_LOSSES = ('loss', 'precision', 'recall')
PROFILE_KEYS = ('kernels', 'logmel_kernels', 'busy_share', 'device_ms_per_step',
                'top_ms_per_step')
SEP_REBUILD_TOL = 1e-3            # separate: voice + background vs the mixture, away from the edges


PROFILE_SCRIPT = r'''
import collections, functools, json, sys
import numpy as np
import torch
from pytorch_sound_tpu_torch.examples import dsd100, ljspeech_tts, maestro
from pytorch_sound_tpu_torch.models import build_model
from pytorch_sound_tpu_torch.trainer import adam, adamw
save_dir, prof_dir, runs = sys.argv[1], sys.argv[2], sys.argv[3:]
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for recipe, batch_path in zip(runs[::2], runs[1::2]):
    data = np.load(batch_path)
    batch = [data['arr_%d' % i] for i in range(len(data.files))]
    cls, arch, opt, grad_norm = {
        'ljspeech_tts': (ljspeech_tts.TTSTrainer, 'transformer_tts_base',
                         functools.partial(adamw, b1=0.9, b2=0.98), 1.0),
        'dsd100': (dsd100.DSD100Trainer, 'spec_unet_base', adam, 5.0),
        'maestro': (maestro.MaestroTrainer, 'frame_pitch_base', adamw, 3.0)}[recipe]
    torch.manual_seed(0)
    model = build_model(arch)
    t = cls(model, opt(model.parameters(), 1e-4), [batch], [batch], max_step=5,
            valid_max_step=1, save_interval=10 ** 9, log_interval=10 ** 9,
            save_dir=save_dir, grad_norm=grad_norm, seed=1, device='cuda',
            profile_dir=prof_dir + '_' + recipe, profile_steps=(3, 5))
    t.run()
    torch.cuda.synchronize()
    events = json.load(open(t.profile_trace))['traceEvents']
    kernels = [e for e in events if e.get('cat') == 'kernel' and 'dur' in e]
    timed = [e for e in events if 'ts' in e and 'dur' in e]
    span = max(e['ts'] + e['dur'] for e in timed) - min(e['ts'] for e in timed)
    busy, end = 0.0, -1.0
    for e in sorted(kernels, key=lambda e: e['ts']):
        start, stop = e['ts'], e['ts'] + e['dur']
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = collections.Counter()
    for e in kernels:
        by_name[e['name'][:60]] += e['dur']
    print(json.dumps({'recipe': recipe, 'trace': t.profile_trace, 'kernels': len(kernels),
                      'window_us': span, 'busy_us': busy, 'steps': 2,
                      'logmel_kernels': sum('logmel' in e['name'] for e in kernels),
                      'top_us': by_name.most_common(6)}))
'''


def profile_steps(runs, work):
    """Two steps of each ``(recipe, batch)`` of ``runs`` ('ljspeech_tts',
    'dsd100' or 'maestro', at its base model) under the trainer's profiler
    window, in one process of their own (a profiler session late in a long
    process drops records). For each recipe: the trace's name and kernel
    count, the window's and the card's busy us, the log-mel kernels in it,
    and derived the busy share, device ms a step and the six kernels with
    the most device time."""
    args = []
    for recipe, batch in runs:
        args += [recipe, os.path.join(work, recipe + '_batch.npz')]
        np.savez(args[-1], *batch)
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, '-c', PROFILE_SCRIPT, os.path.join(work, 'profile_save'),
         os.path.join(work, 'profile'), *args],
        cwd=root, env=dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p])),
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    profs = {}
    for line in out.stdout.strip().splitlines()[-len(runs):]:
        prof = json.loads(line)
        prof['busy_share'] = prof['busy_us'] / prof['window_us']
        prof['device_ms_per_step'] = prof['busy_us'] / 1e3 / prof['steps']
        prof['top_ms_per_step'] = ['%s:%.3f' % (name.replace(' ', '_'), us / 1e3 / prof['steps'])
                                   for name, us in prof.pop('top_us')]
        profs[prof['recipe']] = prof
    return profs


def midi_file(path, pitches, beats):
    """A format-0 MIDI file at 96 ticks a beat, 120 bpm: each pitch of
    ``pitches`` held for ``beats`` beats, one after the other, velocity 90."""
    import struct
    ticks = beats * 96
    track = b'\x00' + bytes([0xFF, 0x51, 0x03]) + (500000).to_bytes(3, 'big')
    for p in pitches:
        var = bytes([0x80 | (ticks >> 7), ticks & 0x7F])
        track += b'\x00' + bytes([0x90, p, 90]) + var + bytes([0x80, p, 0])
    track += b'\x00' + bytes([0xFF, 0x2F, 0x00])
    with open(path, 'wb') as f:
        f.write(b'MThd' + struct.pack('>IHHH', 6, 0, 1, 96)
                + b'MTrk' + struct.pack('>I', len(track)) + track)


def one_step(trainer_cls, arch, opt, batch, dev, work, grad_norm, losses):
    """One step's logged ``losses`` and the gradients of ``arch`` from seed
    0 on the card and on the CPU, from the same weights and batch: (worst
    loss relative error, worst per-parameter gradient relative error and its
    parameter, the card's losses, the card's trainer)."""
    import copy
    import torch
    from pytorch_sound_tpu_torch.models import build_model
    torch.manual_seed(0)
    model = build_model(arch)
    cpu_model = copy.deepcopy(model)
    results, trainers = [], []
    for device, m in ((dev, model), ('cpu', cpu_model)):
        t = trainer_cls(m, opt(m.parameters(), 1e-4), None, None, max_step=1,
                        valid_max_step=1, save_interval=10 ** 9, log_interval=10 ** 9,
                        save_dir=os.path.join(work, 'step'), grad_norm=grad_norm, seed=1,
                        device=device)
        t.optimizer.zero_grad(set_to_none=True)
        loss, meta_ = t.forward(*t.to_device(batch), is_logging=True)
        loss.backward()
        results.append(({k: float(meta_[k][0].detach()) for k in losses},
                        {k: p.grad.detach().cpu().double() for k, p in m.named_parameters()}))
        trainers.append(t)
    (card_l, card_g), (cpu_l, cpu_g) = results
    loss_rel = max(abs(card_l[k] - cpu_l[k]) / abs(cpu_l[k]) for k in losses)
    grad_rel, worst = max((float((card_g[k] - g).norm()) / max(float(g.norm()), 1e-30), k)
                          for k, g in cpu_g.items())
    return loss_rel, grad_rel, worst, card_l, trainers[0]


def timed_steps(trainer, batch, dev, n=10):
    """Median ms of ``n`` training steps in memory (after 3 warm-ups), each
    ending in a synchronize, and the peak memory in GB."""
    import torch
    b = trainer.to_device(batch)
    for _ in range(3):
        trainer._train_step(b, is_logging=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        trainer._train_step(b, is_logging=False)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, torch.cuda.max_memory_allocated(dev) / 1e9


def separation_path(dev, card):
    """Phase 15: separation and transcription. K2 at the Maestro recipe's
    geometry (44.1 kHz, 1024 / 1024 / 256, 80 mels to sr / 2, clipped to -50
    / 30 dB) on 4 x 131072 samples against the plain log-mel in fp64, and
    timed. A DSD100 chunk tree under $TMPDIR (3 songs x 4 chunks of 3 s of
    mixture / voice / background .npy), ``examples.dsd100.main`` with
    ``spec_unet_base`` at 4 x 65536 for 3 steps and a validation batch; one
    step card vs CPU; ``separate`` at 4 x 65536 card vs CPU, its sources
    rebuilding the mixture; the step and ``separate`` times. A Maestro tree
    (12 performances of 4 s at 44.1 kHz with their MIDI files, the released
    records .json), ``make_meta``, ``examples.maestro.main`` with
    ``frame_pitch_base`` at 4 x 131072 for 3 steps and a validation batch,
    K2 counted (one launch a batch); one step card vs CPU; the step time;
    for both recipes two steps profiled in one subprocess (busy share,
    device time a step, the heaviest kernels). Returns (K2's main-path launches,
    the ``logmel`` entry's keys for the Maestro geometry)."""
    import copy
    import random
    import torch
    from pytorch_sound_tpu_torch import settings
    from pytorch_sound_tpu_torch.data.meta.dsd100 import DSD100Meta
    from pytorch_sound_tpu_torch.data.meta.dsd100 import get_datasets as dsd_datasets
    from pytorch_sound_tpu_torch.data.meta.maestro import MaestroMeta
    from pytorch_sound_tpu_torch.data.meta.maestro import get_datasets as mae_datasets
    from pytorch_sound_tpu_torch.examples import dsd100, maestro
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    from pytorch_sound_tpu_torch.trainer import adam, adamw
    from pytorch_sound_tpu_torch.utils.commons import LOGGER
    from pytorch_sound_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(15)
    mel_args = (MAE_SR, settings.MEL_SIZE, settings.N_FFT, settings.WIN_LENGTH,
                settings.HOP_LENGTH, settings.MIN_DB, settings.MAX_DB, settings.MEL_MIN, None)

    def run_main(module, *args, **kw):
        """The recipe's main on the card with K2 counted from 0 and the
        trainer's log lines kept: (best, steps, K2 launches, seconds)."""
        lines = LogLines()
        LOGGER.addHandler(lines)
        np.random.seed(0)
        torch.manual_seed(0)
        lm.fused_log_mel.launches = 0
        try:
            t0 = time.perf_counter()
            best = module.main(*args, num_workers=0, max_step=3, valid_max_step=1,
                               save_interval=3, log_interval=1, device=str(dev), **kw)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            LOGGER.removeHandler(lines)
        return best, lines.train_steps()[0], lm.fused_log_mel.launches, seconds

    # 15.1 K2 at Maestro's geometry, 4 x 131072 (tones and noise), against
    #      the plain log-mel in fp64 on the same card tensor; one launch each
    wav = torch.from_numpy(np.concatenate([
        tones(rng, 2, MAE_SEG), (0.2 * rng.standard_normal((2, MAE_SEG))).astype(np.float32)])
    ).to(dev)
    before = lm.fused_log_mel.launches
    mel = maestro.LOG_MEL(wav)
    launched = lm.fused_log_mel.launches - before
    plain = mel_ops.log_mel_spectrogram(wav, *mel_args)
    plain64 = mel_ops.log_mel_spectrogram(wav.double(), *mel_args)
    torch.cuda.synchronize()
    k2_err = max_err(mel.double(), plain64)
    log('logmel', what='maestro_4x131072', shape=tuple(mel.shape), launches=launched,
        vs_fp64='%.3g' % k2_err, plain_fp32_vs_fp64='%.3g' % max_err(plain.double(), plain64))
    assert mel.shape == (MAE_BATCH, 80, MAE_SEG // 256 + 1) and launched == 1, \
        (mel.shape, launched)
    assert k2_err <= MEL_TOL, k2_err
    with torch.inference_mode():
        k2_ms, k2_plain_ms, k2_runs, plain_runs = paired_ms(
            lambda: mel_ops.log_mel_spectrogram(wav, *mel_args), lambda: maestro.LOG_MEL(wav), 20)
    consts = lm._constants(MAE_SR, 1024, 1024, 80, 0.0, None, str(dev))
    f_used, nnz = consts.mel_w.shape[1], int((consts.mel_w != 0).sum())
    frames = MAE_BATCH * (MAE_SEG // 256 + 1)
    k2_bound, k2_bound_by = bound(
        2.0 * nnz * frames, fft_flops(1024, f_used) * frames,
        4.0 * (MAE_BATCH * MAE_SEG + 80 * frames), fp64_peak=PEAK_FP64_CUDA_CORES)

    work = tempfile.mkdtemp(prefix='chip_smoke_sep_')
    try:
        # 15.2 the DSD100 chunk tree and its meta
        mixtures, vocals, backgrounds = [], [], []
        n_bytes = 0
        for song in range(3):
            d = os.path.join(work, 'dsd', 'song%d' % song)
            os.makedirs(d)
            for i in range(4):
                voice = tones(rng, 1, 3 * MAE_SR)[0] * 0.5
                back = (0.1 * rng.standard_normal(3 * MAE_SR)).astype(np.float32)
                for name, x in (('mixture', voice + back), ('voice', voice),
                                ('background', back)):
                    np.save(os.path.join(d, '%s.%d.npy' % (name, i)), x.astype(np.float32))
                    n_bytes += x.size * 4
            mixtures.append(os.path.join(d, 'mixture.npy'))
            vocals.append(os.path.join(d, 'voice.npy'))
            backgrounds.append(os.path.join(d, 'background.npy'))
        dsd_meta = os.path.join(work, 'dsd_meta')
        random.seed(0)
        DSD100Meta(dsd_meta).make_meta(mixtures, vocals, backgrounds)
        rows = [len(DSD100Meta(os.path.join(dsd_meta, name))) for name in META_FILES]
        log('meta', what='dsd100', npy_mb='%.1f' % (n_bytes / 1e6), rows='/'.join(map(str, rows)))
        assert rows == [12, 11, 1], rows

        # 15.3 main() with spec_unet_base at 4 x 65536: 3 steps, a validation
        #      batch, a checkpoint; no log-mel on this path
        best, steps, k2_sep, sep_s = run_main(dsd100, dsd_meta, os.path.join(work, 'dsd_save'),
                                              batch_size=SEP_BATCH, fix_len=SEP_SEG)
        for s_ in sorted(steps):
            log('train', route='dsd100', step=s_,
                **{k: '%.6f' % steps[s_][k] for k in SEP_LOSSES})
        log('counts', route='dsd100', logmel=k2_sep, steps=3, valid_batches=1,
            best_valid_loss='%.6f' % best, seconds='%.1f' % sep_s)
        assert sorted(steps) == [1, 2, 3] and np.isfinite(best), (sorted(steps), best)
        assert all(np.isfinite(m[k]) for m in steps.values() for k in SEP_LOSSES), steps
        assert k2_sep == 0, k2_sep
        ckpt = os.path.join(work, 'dsd_save', 'models', 'dsd100', 'SpectrogramUNet')
        assert os.listdir(ckpt) == ['step_000003.chkpt'], os.listdir(ckpt)

        #      one step card vs CPU from the same weights and a loader batch
        sep_batch = next(iter(dsd_datasets(dsd_meta, SEP_BATCH, 0, fix_len=SEP_SEG,
                                           pad_multiple=SEP_SEG)[0]))
        assert [b.shape for b in sep_batch] == [(SEP_BATCH, SEP_SEG)] * 3
        loss_rel, grad_rel, worst, card_l, sep_trainer = one_step(
            dsd100.DSD100Trainer, 'spec_unet_base', adam, sep_batch, dev, work, 5.0, SEP_LOSSES)
        log('card_cpu', route='dsd100', losses=card_l, worst_loss_rel='%.3g' % loss_rel,
            worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst,
            params=sum(p.numel() for p in sep_trainer.model.parameters()))
        assert loss_rel <= CARD_CPU_RTOL and grad_rel <= CARD_CPU_GRAD_TOL, \
            (loss_rel, grad_rel, worst)
        sep_ms, sep_gb = timed_steps(sep_trainer, sep_batch, dev)

        # 15.4 separate at 4 x 65536 on the trained weights, card vs CPU; the
        #      two sources rebuild the mixture
        model = sep_trainer.model.eval()
        cpu_model = copy.deepcopy(model).cpu()
        mix = torch.from_numpy(sep_batch[0]).to(dev)
        voice, background = dsd100.separate(model, mix)
        cpu_voice, cpu_background = dsd100.separate(cpu_model, mix.cpu())
        torch.cuda.synchronize()
        sep_rel = max(max_err(a.cpu(), b) / float(b.abs().max())
                      for a, b in ((voice, cpu_voice), (background, cpu_background)))
        rebuild = max_err((voice + background)[:, 1024:-1024], mix[:, 1024:-1024])
        separate_ms = cuda_ms(lambda: dsd100.separate(model, mix), 10)
        log('separate', shape=tuple(voice.shape), card_vs_cpu_rel='%.3g' % sep_rel,
            rebuild_max_abs='%.3g' % rebuild, voice_max='%.3g' % float(voice.abs().max()))
        assert voice.shape == background.shape == mix.shape
        assert bool(torch.isfinite(voice).all()) and bool(torch.isfinite(background).all())
        assert sep_rel <= CARD_CPU_RTOL and rebuild <= SEP_REBUILD_TOL, (sep_rel, rebuild)

        # 15.5 the Maestro tree: 12 performances of 4 s (tones over noise, a
        #      MIDI file each whose notes cover them), the records .json
        root = os.path.join(work, 'maestro')
        os.makedirs(os.path.join(root, '2004'))
        records = []
        for i in range(12):
            wav_rel, mid_rel = '2004/perf%02d.wav' % i, '2004/perf%02d.midi' % i
            x = 0.5 * tones(rng, 1, 4 * MAE_SR)[0] + 0.05 * rng.standard_normal(4 * MAE_SR)
            write_wav(os.path.join(root, wav_rel), np.clip(x, -1, 1).astype(np.float32),
                      MAE_SR, dtype='int16')
            midi_file(os.path.join(root, mid_rel), [48 + (i + k) % 36 for k in range(4)], 2)
            records.append({'canonical_composer': 'Composer %d' % (i % 4),
                            'canonical_title': 'Piece %d' % i, 'split': 'train',
                            'year': 2004, 'midi_filename': mid_rel,
                            'audio_filename': wav_rel, 'duration': 4.0})
        official = os.path.join(root, 'maestro-v1.0.0.json')
        with open(official, 'w') as f:
            json.dump(records, f)
        random.seed(0)
        MaestroMeta(official).make_meta()
        rows = [len(MaestroMeta(os.path.join(root, name)))
                for name in MaestroMeta.frame_file_names]
        log('meta', what='maestro', rows='/'.join(map(str, rows)))
        assert rows == [12, 11, 1], rows

        # 15.6 main() with frame_pitch_base at 4 x 131072: 3 steps and a
        #      validation batch, K2 once a batch
        best, steps, k2_mae, mae_s = run_main(maestro, root, os.path.join(work, 'mae_save'),
                                              batch_size=MAE_BATCH, fix_len=MAE_SEG)
        for s_ in sorted(steps):
            log('train', route='maestro', step=s_,
                **{k: '%.6f' % steps[s_][k] for k in MAE_LOSSES})
        log('counts', route='maestro', logmel=k2_mae, steps=3, valid_batches=1,
            best_valid_loss='%.6f' % best, seconds='%.1f' % mae_s)
        assert sorted(steps) == [1, 2, 3] and np.isfinite(best), (sorted(steps), best)
        assert all(np.isfinite(m[k]) for m in steps.values() for k in MAE_LOSSES), steps
        assert k2_mae == 3 + 1, k2_mae
        ckpt = os.path.join(work, 'mae_save', 'models', 'maestro', 'FramePitchNet')
        assert os.listdir(ckpt) == ['step_000003.chkpt'], os.listdir(ckpt)

        #      one step card vs CPU; the step time
        mae_batch = next(iter(mae_datasets(root, MAE_BATCH, 0, fix_len=MAE_SEG,
                                           pad_multiple=MAE_SEG)[0]))
        assert mae_batch[0].shape == (MAE_BATCH, MAE_SEG) and mae_batch[1].shape[:2] == \
            (MAE_BATCH, 128), [b.shape for b in mae_batch]
        assert float(mae_batch[1].max()) == 90.0
        loss_rel, grad_rel, worst, card_l, mae_trainer = one_step(
            maestro.MaestroTrainer, 'frame_pitch_base', adamw, mae_batch, dev, work, 3.0,
            ('loss',))
        log('card_cpu', route='maestro', losses=card_l, worst_loss_rel='%.3g' % loss_rel,
            worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst,
            params=sum(p.numel() for p in mae_trainer.model.parameters()))
        assert loss_rel <= CARD_CPU_RTOL and grad_rel <= CARD_CPU_GRAD_TOL, \
            (loss_rel, grad_rel, worst)
        mae_ms, mae_gb = timed_steps(mae_trainer, mae_batch, dev)

        # 15.7 both steps under the profiler, in one process of their own
        profs = profile_steps([('dsd100', sep_batch), ('maestro', mae_batch)], work)
        sep_prof, mae_prof = profs['dsd100'], profs['maestro']
        for route, prof in profs.items():
            log('profile', route=route, **{k: prof[k] for k in PROFILE_KEYS})
        assert sep_prof['logmel_kernels'] == 0 and mae_prof['logmel_kernels'] == 2, profs
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log('time', card=repr(card), what='maestro_logmel_4x131072',
        kernel_ms='%.4f,%.4f' % k2_runs, plain_ms='%.4f,%.4f' % plain_runs,
        bound_ms='%.5f' % k2_bound, bound_by=k2_bound_by)
    log('time', card=repr(card), what='dsd100_spec_unet_b4_65536',
        step_ms='%.3f' % float(np.median(sep_ms)),
        step_ms_range='%.3f-%.3f' % (min(sep_ms), max(sep_ms)), peak_memory_gb='%.3f' % sep_gb,
        separate_ms='%.3f' % separate_ms, main_s='%.1f' % sep_s,
        device_busy_share='%.4f' % sep_prof['busy_share'],
        device_ms_per_step='%.3f' % sep_prof['device_ms_per_step'])
    log('time', card=repr(card), what='maestro_frame_pitch_b4_131072',
        step_ms='%.3f' % float(np.median(mae_ms)),
        step_ms_range='%.3f-%.3f' % (min(mae_ms), max(mae_ms)), peak_memory_gb='%.3f' % mae_gb,
        main_s='%.1f' % mae_s, device_busy_share='%.4f' % mae_prof['busy_share'],
        device_ms_per_step='%.3f' % mae_prof['device_ms_per_step'])
    return k2_mae, {'maestro_ms': k2_ms, 'maestro_plain_ms': k2_plain_ms,
                    'maestro_bound_ms': k2_bound, 'maestro_bound_by': k2_bound_by,
                    'maestro_vs_fp64': k2_err}


RING_TOL = 1e-5                   # ring attention vs dense (tests/test_attention.py:157)
MGPU_STEPS = 3                    # phase 16a's steps on each path


def gan_state(trainer):
    """A HiFiGANTrainer's parameters and both optimizers' states, on the CPU."""
    import torch

    def cpu(x):
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x.detach().cpu().clone() if isinstance(x, torch.Tensor) else x

    return cpu({'model': trainer.model_state(), 'gen_opt': trainer.gen_optimizer.state_dict(),
                'disc_opt': trainer.disc_optimizer.state_dict()})


def gan_grads(trainer):
    """A HiFiGANTrainer's gradients of its last step, on the CPU, keyed as
    its ``model_state``: the critics' of the critic phase and the
    generator's of the generator phase, each reduced over the ranks under a
    mesh."""
    return {f: {k: p.grad.detach().cpu().clone() for k, p in m.named_parameters()}
            for f, m in (('gen', trainer.generator), ('mpd', trainer.mpd), ('msd', trainer.msd))}


def worst_rel(got, want):
    """(the largest ||got - want|| / ||want|| over the tensors of two
    {family: {name: tensor}} trees, 'family.name' of that tensor)."""
    rel, worst = 0.0, None
    for family, sd in want.items():
        for key, ref in sd.items():
            r = float((got[family][key].double() - ref.double()).norm()
                      / max(float(ref.double().norm()), 1e-30))
            if r >= rel:
                rel, worst = r, '%s.%s' % (family, key)
    return rel, worst


def gloo_rank(work, steps, t_start):
    """Phase 16b, one of two gloo ranks sharing the card (``spawn_ranks``):
    ``steps`` split steps at full width on the K6 route, 8 rows a rank of
    the 16 x 8192 global batches phase 16a trains on (the same ToneStream
    after the same seed). Saves the parameters and the last step's reduced
    gradients to ``work/rank<r>.pt`` and returns (that path, the logged
    scalars by step, the seconds since ``t_start`` (the parent's
    ``time.time()``) at which the rank entered, had built its models, had
    run its steps and had saved)."""
    times = [time.time() - t_start]
    import torch
    import torch.distributed as dist
    from pytorch_sound_tpu_torch.ops.cuda import _build
    from pytorch_sound_tpu_torch.parallel import local_batches, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _build.library()
    dev = torch.device('cuda', torch.cuda.current_device())
    mesh = make_mesh(device_type='cuda')
    models = build_gan(dev, 0, kernel=True)
    times.append(time.time() - t_start)
    t = make_trainer(models, dev, work, train=local_batches(ToneStream(steps), mesh),
                     max_step=steps, valid_max_step=1, save_interval=10 ** 9, log_interval=1,
                     mesh=mesh)
    t.run()
    torch.cuda.synchronize()
    times.append(time.time() - t_start)
    path = os.path.join(work, 'rank%d.pt' % dist.get_rank())
    torch.save({'model': gan_state(t)['model'], 'grads': gan_grads(t)}, path)
    times.append(time.time() - t_start)
    return path, {step: m for tag, step, m in t.logged if tag == 'train'}, times


def multigpu_path(dev, card):
    """Phase 16: the multi-GPU layer on the one card. (a) one NCCL rank in
    this process: the full-width K6-route HiFi-GAN step with a mesh against
    the same steps without one, bit for bit, with the launch counts; (b) two
    gloo ranks sharing the card against (a)'s single-process step; (c) ring
    attention at world 1, a recipe's ``use_mesh`` path and the dry run.
    Returns the mesh run's launches: (K2, K4, K4's backward, K6 forward,
    dx, dw)."""
    import copy
    import datetime
    from concurrent.futures import ThreadPoolExecutor
    import torch
    import torch.distributed as dist
    from pytorch_sound_tpu_torch.examples import voice_bank as vb
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    from pytorch_sound_tpu_torch.parallel import make_mesh, spawn_ranks
    from pytorch_sound_tpu_torch.parallel.dryrun import dryrun_multigpu
    from pytorch_sound_tpu_torch.parallel.ring_attention import ring_attention

    counters = (lm.fused_log_mel, lm.fused_hifigan_mel_trainable, None,
                gc.conv1d_forward, gc.conv1d_input_grad, gc.conv1d_weight_grad)

    def counts():
        return tuple(lm.fused_hifigan_mel_trainable.bwd_launches if c is None else c.launches
                     for c in counters)

    def zero():
        for c in counters:
            if c is None:
                lm.fused_hifigan_mel_trainable.bwd_launches = 0
            else:
                c.launches = 0

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.cuda.empty_cache()
    phase_t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix='chip_smoke_mgpu_')
    try:
        # 16a. one NCCL rank, in this process, over a file store; the mesh
        #      path's 3 steps against the same 3 steps with no mesh, from the
        #      same weights and batches: every parameter and both optimizers'
        #      states bit-identical; the launches of the mesh run alone
        dist.init_process_group('nccl', init_method='file://' + os.path.join(work, 'store'),
                                rank=0, world_size=1, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = make_mesh()
            runs = {}
            first = build_gan(dev, 0, kernel=True)
            for name, m in (('nccl_mesh', mesh), ('no_mesh', None)):
                models = [copy.deepcopy(x) for x in first]
                zero()
                t = make_trainer(models, dev, os.path.join(work, name),
                                 train=ToneStream(MGPU_STEPS), max_step=2, valid_max_step=1,
                                 save_interval=10 ** 9, log_interval=1, mesh=m)
                before = gan_state(t)['model']
                t.run()
                after_2, grads_2 = gan_state(t)['model'], gan_grads(t)
                t.max_step = MGPU_STEPS
                t.run()
                torch.cuda.synchronize()
                runs[name] = {'state': gan_state(t), 'before': before, 'after_2': after_2,
                              'grads_2': grads_2, 'counts': counts(),
                              'want': expected_gc_launches(*models, steps=MGPU_STEPS,
                                                           valid_batches=0),
                              'logged': {s: v for tag, s, v in t.logged if tag == 'train'},
                              'step_ms': 1e3 * float(np.mean(t._step_times[1:]))}
                if m is not None:
                    # the reduction alone on each phase's gradients (one flat
                    # buffer, weight 1, the NCCL all-reduce of one rank)
                    one = torch.ones((), dtype=torch.float64, device=dev)
                    params = {'critics': list(itertools.chain(t.mpd.parameters(),
                                                              t.msd.parameters())),
                              'generator': list(t.generator.parameters())}
                    reduce_ms = {phase: cuda_ms(lambda ps=ps: t.reduce_grads(ps, one), 5)
                                 for phase, ps in params.items()}
                    grad_mb = {phase: sum(p.numel() for p in ps) * 4 / 1e6
                               for phase, ps in params.items()}
                    del params
                del t, models
            del first
            mesh_run, plain = runs['nccl_mesh'], runs['no_mesh']
            identical = same_state(mesh_run['state'], plain['state'])
            for s in range(1, MGPU_STEPS + 1):
                log('mgpu', run='nccl_world1', step=s,
                    **{k: '%.6f' % mesh_run['logged'][s][k] for k in LOSSES})
            log('mgpu', what='nccl_world1_vs_no_mesh', steps=MGPU_STEPS,
                bit_identical=identical, counts='%d/%d/%d/%d/%d/%d' % mesh_run['counts'],
                expected_k6='%d/%d/%d' % mesh_run['want'])
            log('time', card=repr(card), what='train_step_16x8192_k6_mesh',
                nccl_world1_step_ms='%.2f' % mesh_run['step_ms'],
                no_mesh_step_ms='%.2f' % plain['step_ms'],
                reduction_ms='%.2f' % (mesh_run['step_ms'] - plain['step_ms']),
                reduce_critics_ms='%.3f' % reduce_ms['critics'],
                reduce_generator_ms='%.3f' % reduce_ms['generator'],
                critics_grad_mb='%.1f' % grad_mb['critics'],
                generator_grad_mb='%.1f' % grad_mb['generator'])
            assert identical, 'the NCCL world-1 mesh step differs from the step with no mesh'
            for run in (mesh_run, plain):
                assert run['counts'] == (2 * MGPU_STEPS, MGPU_STEPS, MGPU_STEPS,
                                         *run['want']), (run['counts'], run['want'])

            # 16c. ring attention at world 1 (the local attention, no P2P)
            #      against dense on the card, every local strategy
            seq_mesh = make_mesh(axis_names=('seq',))
            g = torch.Generator(device=dev).manual_seed(16)
            q, k, v = (torch.randn((2, 4, 4096, 64), generator=g, device=dev)
                       for _ in range(3))
            dense = torch.softmax(q @ k.transpose(-1, -2) / 8.0, dim=-1) @ v
            ring_err = {local: float((ring_attention(q, k, v, seq_mesh, axis='seq',
                                                     local=local) - dense).abs().max())
                        for local in ('auto', 'dense', 'blockwise')}
            torch.cuda.synchronize()
            log('mgpu', what='ring_attention_world1', shape=tuple(q.shape),
                **{'%s_max_abs_err' % k_: '%.3g' % e for k_, e in ring_err.items()})
            assert max(ring_err.values()) <= RING_TOL, ring_err
            del q, k, v, dense

            #      the VoiceBank recipe's use_mesh path as torchrun starts it
            #      with one process (its environment, the group running),
            #      on phase 12's tree, 2 steps
            meta, _, _ = voice_bank_tree(os.path.join(work, 'vb'))
            env = {key: os.environ.get(key) for key in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK')}
            os.environ.update(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0')
            try:
                t0 = time.perf_counter()
                best = vb.main(meta, os.path.join(work, 'vb_save'), batch_size=ENH_BATCH,
                               num_workers=0, fix_len=ENH_SEG, max_step=2, valid_max_step=1,
                               save_interval=2, log_interval=1, use_mesh=True, device='cuda')
                torch.cuda.synchronize()
            finally:
                for key, value in env.items():
                    if value is None:
                        os.environ.pop(key, None)
                    else:
                        os.environ[key] = value
            ckpt = os.path.join(work, 'vb_save', 'models', 'voice_bank', 'SpectrogramMaskNet',
                                'step_000002.chkpt')
            log('mgpu', what='voice_bank_main_use_mesh_nccl_world1', steps=2,
                best_valid_loss='%.6f' % best, checkpoint=os.path.exists(ckpt),
                seconds='%.1f' % (time.perf_counter() - t0))
            assert np.isfinite(best) and os.path.exists(ckpt), (best, ckpt)
        finally:
            dist.destroy_process_group()
        torch.cuda.empty_cache()

        # 16b. two gloo ranks sharing the card, 8 rows each of the same
        #      global batches, 2 steps, against 16a's single-process steps;
        #      meanwhile (16c) the dry run on one NCCL rank, a process of its own
        t0 = time.perf_counter()
        with ThreadPoolExecutor(1) as pool:
            dry = pool.submit(dryrun_multigpu, 1, 'cuda')
            ranks = spawn_ranks(gloo_rank, 2, 'gloo', 'cuda', work, 2, time.time(),
                                deadline_s=240)
            gloo_s = time.perf_counter() - t0
            dry = dry.result()
        dry_s = time.perf_counter() - t0
        log('mgpu', what='dryrun_multigpu_1_cuda', seconds='%.1f' % dry_s,
            **{k: '%.6g' % v for k, v in dry.items()})
        saved = [torch.load(path, weights_only=True) for path, _, _ in ranks]
        params = [r['model'] for r in saved]
        before, ref, ref_logged = plain['before'], plain['after_2'], plain['logged']
        loss_rel = max(abs(logged[s][k] - ref_logged[s][k]) / abs(ref_logged[s][k])
                       for _, logged, _ in ranks for s in (1, 2) for k in LOSSES)
        # the step's size shows in the gradients (Adam's steps hardly change
        # when every gradient is scaled alike) and in the parameters' change,
        # not in the parameters themselves, which 2 steps barely move
        grad_rel, grad_worst = worst_rel(saved[0]['grads'], plain['grads_2'])
        change_rel, change_worst = worst_rel(
            {f: {k: params[0][f][k] - before[f][k] for k in sd} for f, sd in ref.items()},
            {f: {k: sd[k] - before[f][k] for k in sd} for f, sd in ref.items()})
        ranks_equal = same_state(params[0], params[1])
        for s in (1, 2):
            log('mgpu', run='gloo_2_ranks', step=s,
                **{k: '%.6f/%.6f' % (ranks[0][1][s][k], ref_logged[s][k]) for k in LOSSES})
        log('mgpu', what='gloo_2_ranks_vs_one_process', steps=2,
            worst_loss_rel='%.3g' % loss_rel, worst_grad_rel='%.3g' % grad_rel,
            worst_grad=grad_worst, worst_change_rel='%.3g' % change_rel,
            worst_change=change_worst, ranks_bit_identical=ranks_equal,
            seconds='%.1f' % gloo_s,
            rank_times_s=' '.join('/'.join('%.1f' % x for x in r[2]) for r in ranks))
        assert loss_rel <= CARD_CPU_RTOL, loss_rel
        assert grad_rel <= CARD_CPU_GRAD_TOL, (grad_worst, grad_rel)
        assert change_rel <= CARD_CPU_GRAD_TOL, (change_worst, change_rel)
        assert ranks_equal, 'the gloo ranks hold different parameters'

    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.backends.cudnn.deterministic = False
    log('mgpu', what='phase_16', seconds='%.1f' % (time.perf_counter() - phase_t0))
    return mesh_run['counts']


FAST_MODES = ('bf16x3', 'default')   # phase 17: the stage kernels' bf16 modes
# a stage kernel in a bf16 mode vs the plain version of that mode, of the plain
# version's max abs, or for a last stage of the largest sum of its conv_post's
# absolute products (the scale tanh's input is rounded at, ~3-10x the
# waveform's max: ``post_scale``; tests/test_torch_gen_stage_tc.py emulates
# the sums): bf16x3 keeps ~16 bits of each operand, so an fp32 ulp of
# difference moves a product by up to 2^-17; 'default' turns such
# differences into whole bf16 ulps (2^-8) of the next conv's operands, which
# compound over a stage
MODE_TOL = {'bf16x3': 2 ** -16, 'default': 2 ** -7}
# the v2 decode in a mode, card vs CPU: each mode's decode moves by its own
# rounding wherever a sum's order differs (bf16x3 by ~2^-17 of a product,
# 'default' by whole bf16 ulps), so DECODE_TOL (2e-4) x 5 and 2^-4, ~16x and
# ~3x what this phase measured on an H100 (6.4e-5, 0.0193); the bf16 dtype
# path, whose cuDNN and CPU convs round at their own places (each up to
# ~0.18 off the fp32 decode), by its SNR against the CPU (MODE_MIN_SNR) and
# a mean abs difference within 2^-8
MODE_DECODE_TOL = {'bf16x3': 1e-3, 'default': 2 ** -4}
# the 'bf16x3' streaming interior vs its whole decode: the kernel sums alike
# in any tile, but v2's conv_pre (cuDNN, outside the kernel) may round a
# chunk's input an ulp off the whole one's, which bf16x3's split moves by up
# to ~2^-17 of each product downstream (measured on an H100: exactly 0)
MODE_STREAM_TOL = 1e-4
# each fast decode against 'highest' on the bench mel (SNR in dB, at least):
# on an H100 81.9 (bf16x3), 27.3 (default), 21.9 (the bf16 dtype), and
# v1's seeded weights 97.5, 42.8, 39.3
MODE_MIN_SNR = {'bf16x3': 60.0, 'default': 20.0, 'bfloat16': 15.0}
# ... and at most: a mode run as 'highest' decodes bit for bit as 'highest'
# does, and 'default' run as 'bf16x3' would read 82-98 dB
MODE_MAX_SNR = {'bf16x3': 110.0, 'default': 60.0}
# that a stage kernel ran its mode and rounded to nearest even, which
# MODE_TOL alone cannot show (bf16x3 moves a stage only ~5e-6 of its max off
# 'highest', below 2^-16): its RMS distance to the plain version of its mode
# at most MODE_RMS_RATIO of its RMS distance to the plain 'highest'. The
# kernel's sums differ from the plain version's only in order: on an H100
# 0.04-0.38 (bf16x3) and 0.003-0.19 (default) on v2's and v1's stages; on
# the CPU, the plain version summed in fp64 for a kernel that truncates its
# splits or roundings reads 0.98 or more, and one that runs another mode
# moves by that mode's whole effect
MODE_RMS_RATIO = 0.5
PEAK_BF16 = 989e12                # dense bf16 on the tensor cores


def bf16_bound(flops, nbytes, passes):
    """(ms, 'operations' or 'bytes') of a stage kernel call in a bf16 mode:
    ``passes`` bf16 products (3 in 'bf16x3', 1 in 'default') per product of
    every conv of the stage (conv_pre, the transposed conv, the resblock
    convs, conv_post) at the bf16 tensor-core peak, or its bytes over the
    memory rate, whichever is larger. The kernel takes conv_pre's and
    conv_post's products on the CUDA cores (as fp32 FMAs of the split or
    rounded operands), a cost it pays against this bound."""
    ops_s = passes * flops / PEAK_BF16
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s) * 1e3, 'operations' if ops_s >= bytes_s else 'bytes'


def rms(t):
    return float(t.double().pow(2).mean().sqrt())


def snr_db(ref, out):
    return 10 * float(np.log10(float((ref.double() ** 2).sum())
                               / max(float(((out - ref).double() ** 2).sum()), 1e-300)))


def fast_modes_path(dev, card, rng):
    """Phase 17: the serving fast modes. Returns the JSON entries of K1 (v2's
    narrow stages, v1's wide ones) in 'bf16x3' and 'default' and of K3 in
    'default'."""
    import torch
    import torch.nn.functional as F
    from pytorch_sound_tpu_torch.interface.hifi_gan import InterfaceHifiGAN
    from pytorch_sound_tpu_torch.models import build_model
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (generator_apply_fused,
                                                                  init_params)
    from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs

    t_start = time.perf_counter()
    v2 = {m: InterfaceHifiGAN('hifi_gan_v2', device='cuda', precision=m)
          for m in ('highest',) + FAST_MODES}
    v2_bf16 = InterfaceHifiGAN('hifi_gan_v2', device='cuda', dtype='bfloat16')
    tree = state_tree(init_params(build_model('hifi_gan_v1'), torch.Generator().manual_seed(0)))
    v1 = {m: InterfaceHifiGAN('hifi_gan_v1', params=tree, device='cuda', precision=m)
          for m in ('highest',) + FAST_MODES}
    v1_bf16 = InterfaceHifiGAN('hifi_gan_v1', params=tree, device='cuda', dtype='bfloat16')
    gen2, gen1 = v2['highest'].decoder, v1['highest'].decoder
    errs = {(kind, m): 0.0 for kind in ('narrow', 'wide', 'resblock') for m in FAST_MODES}

    def held(kind, mode, ker, ref, highest, scale=0.0, **fields):
        """A kernel output against the plain version of its mode, within
        MODE_TOL of the larger of the plain version's max abs and ``scale``,
        and nearer it than the plain 'highest' (MODE_RMS_RATIO)."""
        torch.cuda.synchronize()
        err, ref_max = max_err(ker, ref), float(ref.abs().max())
        errs[kind, mode] = max(errs[kind, mode], err)
        scale = max(scale, ref_max)
        ratio = rms(ker - ref) / max(rms(ker - highest), 1e-300)
        log('fast_' + kind, mode=mode, shape=tuple(ker.shape), max_abs_err='%.3g' % err,
            ref_max='%.3g' % ref_max, scale='%.3g' % scale, rel='%.3g' % (err / scale),
            rms_vs_highest_ratio='%.3g' % ratio, **fields)
        assert ker.shape == ref.shape and err <= MODE_TOL[mode] * scale, (kind, mode, fields)
        assert ratio <= MODE_RMS_RATIO, (kind, mode, ratio, fields)

    def post_scale(x, args, mode):
        """For a stage with conv_post, the largest sum of its absolute
        products in the plain version of ``mode``; else 0."""
        if args['conv_post'] is None:
            return 0.0
        mean = gs.generator_stage_reference(x, **dict(args, conv_post=None), precision=mode)
        w = args['conv_post'][0]
        return float(F.conv1d(F.leaky_relu(mean, 0.01).abs(), w.abs(),
                              padding=(w.shape[-1] - 1) // 2).max())

    def upsampled(gen, x, i):
        h = gen.conv_pre(x) if i == 0 else x
        return getattr(gen, 'ups_%d' % i)(F.leaky_relu(h, 0.1))

    bench2 = torch.from_numpy((np.random.default_rng(7).standard_normal((32, 80, 256))
                               .astype(np.float32) * 2 - 4)).to(dev)   # bench.py:372
    bench1 = v1['highest'].encode(tones(rng, BATCH, 256 * UP))[..., :256].contiguous()

    # 17.1 each stage kernel in each mode against the plain version of that
    #      mode, on the same card tensor: v2's four stages on the bundled
    #      weights fed by the real conv_pre and the plain stages before (as
    #      phase 4), v1's four seeded stages (the cluster layout, conv_pre
    #      folded into stage 0), K3 'default' on v1's resblock inputs
    with torch.inference_mode():
        for mel in (v2['highest'].encode(tones(rng, 4, 61 * UP))[..., :61], bench2):
            x = gen2.conv_pre(mel)
            for i in range(4):
                args = gen2.stage_args(i)
                highest = gs.generator_stage_reference(x, **args)
                for m in FAST_MODES:
                    held('narrow', m, gs.generator_stage(x, **args, precision=m),
                         gs.generator_stage_reference(x, **args, precision=m), highest,
                         post_scale(x, args, m), model='v2', batch=mel.shape[0],
                         frames=mel.shape[2], stage=i)
                x = highest
        for mel in (v1['highest'].encode(tones(rng, 2, 61 * UP))[..., :61].contiguous(), bench1):
            x = mel
            for i in range(4):
                args = gen1.stage_args(i, fold_conv_pre=i == 0)
                highest = gs.generator_stage_reference(x, **args)
                for m in FAST_MODES:
                    held('wide' if i < 2 else 'narrow', m,
                         gs.generator_stage(x, **args, precision=m),
                         gs.generator_stage_reference(x, **args, precision=m), highest,
                         post_scale(x, args, m), model='v1', batch=mel.shape[0],
                         frames=mel.shape[2], stage=i)
                h = upsampled(gen1, x, i)
                held('resblock', 'default', gs.resblock_stage(h, args['blocks'], 'default'),
                     gs.resblock_stage_reference(h, args['blocks'], 'default'),
                     gs.resblock_stage_reference(h, args['blocks']),
                     model='v1', batch=mel.shape[0], frames=mel.shape[2], stage=i)
                x = highest

    # 17.2 the main paths, counters from zero: the interfaces in each mode
    #      (v2: the bench decode, a card slice, streaming and its whole
    #      decode in 'bf16x3'; v1: the bench decode), the bf16 dtype decode
    #      (no K1), K3 'default' through resblock_stage on v1's stages
    with torch.inference_mode():
        highest = v2['highest'].decode(bench2)
        long_mel = bench2[:1].repeat(1, 1, 16).contiguous()              # 1 x 4096 frames
        long_highest = v2['highest'].decode(long_mel)
        v1_highest = v1['highest'].decode(bench1)
        x = bench1
        res_in = []
        for i in range(4):
            res_in.append(upsampled(gen1, x, i))
            x = gs.generator_stage_reference(x, **gen1.stage_args(i, fold_conv_pre=i == 0))
    torch.cuda.synchronize()
    gs.reset_launches()
    decoded = dict.fromkeys(FAST_MODES, 0)
    wide = dict.fromkeys(FAST_MODES, 0)
    out, slices, quality = {}, {}, {}
    for m in FAST_MODES + ('bfloat16',):
        iface = v2_bf16 if m == 'bfloat16' else v2[m]
        out[m] = iface.decode(bench2)
        slices[m] = iface.decode(bench2[:2, :, :64])
        if m in decoded:
            decoded[m] += 2
    streamed = v2['bf16x3'].decode_streaming(long_mel, chunk_frames=256, overlap_frames=32)
    whole = v2['bf16x3'].decode(long_mel)
    decoded['bf16x3'] += 2
    for m in FAST_MODES:
        before = gs.generator_stage.wide_launches
        out['v1_' + m] = v1[m].decode(bench1)
        wide[m] = gs.generator_stage.wide_launches - before
        decoded[m] += 1
    out['v1_bfloat16'] = v1_bf16.decode(bench1)
    with torch.inference_mode():
        k3_out = [gs.resblock_stage(h, gen1.stage_blocks(i), 'default')
                  for i, h in enumerate(res_in)]
    torch.cuda.synchronize()
    launches = dict(gs.generator_stage.launches_by_mode)
    k3_launches = dict(gs.resblock_stage.launches_by_mode)
    log('counts', path='fast_modes', decoded_batches=decoded, k1=launches,
        k1_wide=gs.generator_stage.wide_launches, k3=k3_launches)
    assert launches == {'highest': 0, 'bf16x3': 4 * decoded['bf16x3'],
                        'default': 4 * decoded['default']}, launches
    assert wide == {'bf16x3': 2, 'default': 2}, wide
    assert gs.generator_stage.wide_launches == 4, gs.generator_stage.wide_launches
    assert k3_launches == {'highest': 0, 'default': 4}, k3_launches

    for m in FAST_MODES + ('bfloat16',):
        o = out[m]
        assert o.shape == highest.shape and o.dtype == torch.float32
        assert bool(torch.isfinite(o).all()) and float(o.abs().max()) <= 1.0
        err = o - highest
        quality[m] = (float(err.abs().max()), float(err.abs().mean()), snr_db(highest, o))
        v1_err = out['v1_' + m] - v1_highest
        v1_snr = snr_db(v1_highest, out['v1_' + m])
        label = 'bf16_dtype' if m == 'bfloat16' else m
        log('fast_decode', card=repr(card), mel=tuple(bench2.shape), **{
            'vocoder_%s_waveform_max_err' % label: '%.6g' % quality[m][0],
            'vocoder_%s_waveform_mean_err' % label: '%.6g' % quality[m][1],
            'vocoder_%s_snr_db' % label: '%.2f' % quality[m][2],
            'v1_%s_max_err' % label: '%.4g' % float(v1_err.abs().max()),
            'v1_%s_snr_db' % label: '%.2f' % v1_snr})
        assert min(quality[m][2], v1_snr) >= MODE_MIN_SNR[m], (m, quality[m], v1_snr)
        assert max(quality[m][2], v1_snr) <= MODE_MAX_SNR.get(m, np.inf), (m, quality[m], v1_snr)
    for i, (h, got) in enumerate(zip(res_in, k3_out)):
        blocks = gen1.stage_blocks(i)
        held('resblock', 'default', got, gs.resblock_stage_reference(h, blocks, 'default'),
             gs.resblock_stage_reference(h, blocks), model='v1', main_path=True, stage=i)

    #      card vs CPU per mode, the streaming interior vs the whole decode
    for m in FAST_MODES + ('bfloat16',):
        kw = dict(dtype='bfloat16') if m == 'bfloat16' else dict(precision=m)
        cpu = InterfaceHifiGAN('hifi_gan_v2', device='cpu', **kw).decode(bench2[:2, :, :64].cpu())
        err = max_err(slices[m].cpu(), cpu)
        mean = float((slices[m].cpu() - cpu).abs().mean())
        snr = snr_db(cpu, slices[m].cpu())
        log('fast_decode', mode=m, card_vs_cpu_max_abs_err='%.3g' % err,
            card_vs_cpu_mean_abs_err='%.3g' % mean, card_vs_cpu_snr_db='%.2f' % snr)
        if m == 'bfloat16':
            assert snr >= MODE_MIN_SNR[m] and mean <= 2 ** -8, (m, snr, mean)
        else:
            assert err <= MODE_DECODE_TOL[m], (m, err)
    edge = 10 * UP
    err = max_err(streamed[..., edge:-edge], whole[..., edge:-edge])
    log('fast_stream', mode='bf16x3', mel=tuple(long_mel.shape), interior_max_abs_err='%.3g' % err,
        whole_vs_highest_max_abs_err='%.3g' % max_err(whole, long_highest))
    assert streamed.shape == whole.shape == (1, 1, 4096 * UP) and err <= MODE_STREAM_TOL, err

    # 17.3 timings (CUDA events): each mode's decode beside 'highest', the
    #      plain versions of the mode and the bf16 dtype path, per stage, with
    #      the bf16 tensor-core bounds
    results = {}
    with torch.inference_mode():
        for name, gen, mel, fold, iters, bf16_iface in (
                ('v2_32x256', gen2, bench2, False, 10, v2_bf16),
                ('v1_16x256', gen1, bench1, True, 3, v1_bf16)):
            stage_in = [mel if fold else gen.conv_pre(mel)]
            for i in range(3):
                stage_in.append(gs.generator_stage_reference(
                    stage_in[-1], **gen.stage_args(i, fold_conv_pre=fold and i == 0)))
            work = [stage_work(x, gen.stage_args(i, fold and i == 0))
                    for i, x in enumerate(stage_in)]
            dec = {m: cuda_ms(lambda m=m: generator_apply_fused(gen, mel, precision=m), iters)
                   for m in ('highest',) + FAST_MODES}
            dec['bfloat16'] = cuda_ms(lambda: bf16_iface.decoder(mel.to(torch.bfloat16)).float(),
                                      iters)
            per = {}
            for m in ('highest',) + FAST_MODES:
                per[m] = [paired_ms(
                    lambda x=x, i=i, m=m: gs.generator_stage_reference(
                        x, **gen.stage_args(i, fold and i == 0), precision=m),
                    lambda x=x, i=i, m=m: gs.generator_stage(
                        x, **gen.stage_args(i, fold and i == 0), precision=m), iters)[:2]
                    for i, x in enumerate(stage_in)]
            bounds = {m: [bf16_bound(f, b, 3 if m == 'bf16x3' else 1) for f, b in work]
                      for m in FAST_MODES}
            results[name] = (per, bounds, work)
            log('time', card=repr(card), what='fast_decode_' + name,
                gflop='%.1f' % (sum(f for f, _ in work) / 1e9),
                **{'%s_ms' % m: '%.4f' % dec[m] for m in dec},
                **{'%s_speedup' % m: '%.3f' % (dec['highest'] / dec[m])
                   for m in FAST_MODES + ('bfloat16',)})
            for m in ('highest',) + FAST_MODES:
                fields = dict(per_stage_kernel_ms='/'.join('%.4f' % k for k, _ in per[m]),
                              per_stage_plain_ms='/'.join('%.4f' % p for _, p in per[m]))
                if m in FAST_MODES:
                    fields.update(
                        per_stage_bf16_bound_ms='/'.join('%.4f' % b for b, _ in bounds[m]),
                        per_stage_share_of_bound='/'.join(
                            '%.4f' % (b / k) for (b, _), (k, _) in zip(bounds[m], per[m])),
                        stages_share_of_bound='%.4f' % (sum(b for b, _ in bounds[m])
                                                        / sum(k for k, _ in per[m])))
                log('time', card=repr(card), what='fast_stages_' + name, mode=m, **fields)
        res_per = [paired_ms(lambda h=h, i=i: gs.resblock_stage_reference(
                                 h, gen1.stage_blocks(i), 'default'),
                             lambda h=h, i=i: gs.resblock_stage(h, gen1.stage_blocks(i), 'default'),
                             3)[:2] for i, h in enumerate(res_in)]
        res_hi = [cuda_ms(lambda h=h, i=i: gs.resblock_stage(h, gen1.stage_blocks(i)), 3)
                  for i, h in enumerate(res_in)]
    res_work = [resblock_work(h, gen1.stage_blocks(i)) for i, h in enumerate(res_in)]
    res_bound = bf16_bound(sum(f for f, _ in res_work), sum(b for _, b in res_work), 1)
    log('time', card=repr(card), what='fast_k3_v1_16x256', mode='default',
        per_stage_kernel_ms='/'.join('%.4f' % k for k, _ in res_per),
        per_stage_plain_ms='/'.join('%.4f' % p for _, p in res_per),
        per_stage_highest_ms='/'.join('%.4f' % k for k in res_hi),
        bf16_bound_ms='%.4f' % res_bound[0],
        share_of_bound='%.4f' % (res_bound[0] / sum(k for k, _ in res_per)))

    def entry(name, mode, stages, model, kind, count, replaces):
        per, _, work = results[model]
        b = bf16_bound(sum(work[i][0] for i in stages), sum(work[i][1] for i in stages),
                       3 if mode == 'bf16x3' else 1)
        return {'name': name, 'route': 'cuda', 'source': gs.SOURCE, 'replaces': replaces,
                'precision': mode, 'launches': count, 'max_abs_err': errs[kind, mode],
                'ms': sum(per[mode][i][0] for i in stages),
                'plain_ms': sum(per[mode][i][1] for i in stages),
                'bound_ms': b[0], 'bound_by': b[1], 'tc_bound_ms': b[0], 'library_ms': None}

    k1 = 'pytorch_sound_tpu/ops/pallas/gen_stage.py:282'
    entries = []
    for m in FAST_MODES:
        entries.append(entry('gen_stage_' + m, m, range(4), 'v2_32x256', 'narrow',
                             launches[m] - wide[m], k1))
        entries.append(entry('gen_stage_wide_' + m, m, (0, 1), 'v1_16x256', 'wide', wide[m], k1))
    entries.append({'name': 'resblock_stage_default', 'route': 'cuda', 'source': gs.SOURCE,
                    'replaces': 'pytorch_sound_tpu/ops/pallas/resblock.py:155',
                    'precision': 'default', 'launches': k3_launches['default'],
                    'max_abs_err': errs['resblock', 'default'],
                    'ms': sum(k for k, _ in res_per), 'plain_ms': sum(p for _, p in res_per),
                    'bound_ms': res_bound[0], 'bound_by': res_bound[1],
                    'tc_bound_ms': res_bound[0], 'library_ms': None})
    log('fast_modes', seconds='%.1f' % (time.perf_counter() - t_start))
    return entries


CRITIC_MODES = ('default', 'bf16')   # phase 18: K6's routes besides 'highest'
# phase 18, K6 in 'default' on float32 tensors against the plain version of
# the mode: GC_FWD_TOL / GC_GRAD_TOL of its max abs (the same operands
# rounded the same way and exact products: only the fp32 sums' order
# differs); on bfloat16 tensors the same plus one bf16 ulp at the binade of
# that max (both round once from fp32 sums, and may round apart). Each also
# nearer the plain version of its mode than the plain 'highest' of the
# float32 operands by RMS (MODE_RMS_RATIO).
# The recipe's step in a critic mode, card vs CPU (the plain versions of the
# mode): a sum whose order differs may round an operand of the next layer to
# the neighbouring bf16 value (2^-8 of it), so the step moves by more than in
# 'highest': each of the five losses, relative (on an H100 at most 1.2e-5),
MODE_STEP_RTOL = 2e-4
# ... and each parameter's gradient, ||g_card - g_cpu|| / ||g_cpu|| (at most
# 0.018, the MSD's first layers, whose cotangents carry the most roundings)
MODE_STEP_GRAD_TOL = 5e-2
FOLD_TOL = 2e-5                   # folded vs unfolded MSD (tests/test_hifigan_training.py:310)
FOLD_GRAD_RTOL, FOLD_GRAD_ATOL = 5e-4, 5e-5   # its gradients (:342-343)


def bf16_ulp(scale):
    """One bf16 ulp at the binade of ``scale`` (7 stored mantissa bits)."""
    return 2.0 ** (np.floor(np.log2(scale)) - 7)


def folded_layers(msd, x):
    """The folded MSD's 8 convs on x: [(name, input, weight, bias, conv
    keywords, slope)], each input as ``msd_apply_folded`` feeds it."""
    import torch
    from pytorch_sound_tpu_torch.models.vocoders import discriminators as disc
    layers, route = [], disc.conv1d_route

    def record(x_, w, b, **kw):
        name = 'msd_folded.%s' % ('conv_%d' % len(layers) if len(layers) < 7 else 'conv_post')
        conf = {k: kw[k] for k in ('stride', 'padding', 'groups', 'dilation')}
        layers.append((name, x_.contiguous(), w.detach(), b.detach(), conf, kw['slope']))
        return route(x_, w, b, **kw)

    disc.conv1d_route = record
    try:
        with torch.no_grad():
            disc.msd_apply_folded(msd, x)
    finally:
        disc.conv1d_route = route
    return layers


def cudnn_routes(x, w, b, gy, conf, slope=None, transposed=False, precision='default'):
    """cuDNN's conv of one layer as the port's cuDNN route runs it: {entry:
    a function}. In 'default' the repaired route (``hifi_gan.rounded_conv``:
    the fp32 conv of the bf16-rounded operands, its backward rounding the
    cotangent); the forward takes the slope after it, dx and dw go through
    the route's autograd function with only their operand asking for a
    gradient. At 'highest' ``aten.convolution`` and its
    ``convolution_backward`` in fp32. ``conf``: stride, padding, dilation,
    groups (a transposed conv: stride and padding)."""
    import torch
    import torch.nn.functional as F
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import rounded_conv
    conf = dict(dict(dilation=1, groups=1), **conf)
    if precision == 'highest':
        args = ([conf['stride']], [conf['padding']], [conf['dilation']], transposed, [0],
                conf['groups'])

        def back(i):
            mask = [i == 0, i == 1, False]
            return lambda: torch.ops.aten.convolution_backward(gy, x, w, None, *args, mask)[i]
        return {'fwd': lambda: torch.ops.aten.convolution(x, w, b, *args),
                'dx': back(0), 'dw': back(1)}
    kw = dict(conf, transposed=transposed)

    def fwd():
        y = rounded_conv(x, w, b, **kw)
        return y if slope is None else F.leaky_relu(y, slope)
    xg, wg = x.detach().requires_grad_(True), w.detach().requires_grad_(True)
    y_dx, y_dw = rounded_conv(xg, w, b, **kw), rounded_conv(x, wg, b, **kw)
    return {'fwd': fwd,
            'dx': lambda: torch.autograd.grad(y_dx, xg, gy, retain_graph=True)[0],
            'dw': lambda: torch.autograd.grad(y_dw, wg, gy, retain_graph=True)[0]}


def critic_modes_path(dev, card, cudnn_step):
    """Phase 18: the critics' fast modes on K6. Returns the JSON entries of
    the three grouped-conv entry points in 'default' (float32 tensors) and
    on bfloat16 tensors."""
    import torch
    import torch.nn.functional as F
    from pytorch_sound_tpu_torch.models.vocoders import discriminators as disc
    from pytorch_sound_tpu_torch.models.vocoders import hifi_gan as hg
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import WNConv1d
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm

    t_start = time.perf_counter()
    bf = torch.bfloat16
    # 18a each entry point in 'default' on float32 and on bfloat16 tensors
    #     against the plain version of its mode, on every conv of MPD base
    #     and MSD base at the critic phase's 32 x 8192 inputs (phase 8's) and
    #     on the folded MSD's 8 convs, from seeded cotangents
    gen, mpd, msd = build_gan(dev, 0)
    real = torch.from_numpy(tones(np.random.default_rng(8), BATCH, SEG)).to(dev)[:, None, :]
    with torch.no_grad():
        mel = lm.fused_hifigan_mel(real[:, 0])
        both = torch.cat([real, gen(mel)], dim=0)
    layers = [(name, x, m.folded_weight().detach(), m.bias.detach(),
               dict(stride=m.stride, padding=m.padding, groups=m.groups, dilation=m.dilation),
               m.fused_slope)
              for name, m, x in capture_layers(gen, mpd, msd, real, mel)
              if isinstance(m, WNConv1d)]
    layers += folded_layers(msd, both)
    del gen, mpd, msd
    rng = torch.Generator(device=dev).manual_seed(18)
    entries = ('fwd', 'dx', 'dw')
    errs = {(e, r): 0.0 for e in entries for r in CRITIC_MODES}
    ratios = {(e, r): 0.0 for e in entries for r in CRITIC_MODES}
    keys = ('default', 'plain', 'bf16', 'plain_bf16', 'highest', 'cudnn_bf16', 'cudnn_default')
    # the repaired cuDNN route in 'default' against the same plain version of
    # the mode at the same bounds
    cudnn_errs = dict.fromkeys(entries, 0.0)
    cudnn_ratios = dict(cudnn_errs)
    # every critic conv, the unfolded MSD's alone, the folded MSD's
    sums = {part: {e: dict.fromkeys(keys, 0.0) for e in entries}
            for part in ('critics', 'msd', 'folded')}
    work = {part: {e: [0.0, 0.0] for e in entries} for part in sums}   # FLOPs, elements
    for name, x, w, b, conf, slope in layers:
        parts = (('folded',) if name.startswith('msd_folded') else
                 ('critics', 'msd') if name.startswith('msd.') else ('critics',))
        n, _, t = x.shape
        y32 = gc.grouped_conv1d_reference(x, w, b, slope=slope, **conf)
        gy = torch.randn(y32.shape, generator=rng, device=dev)
        xb, wb, gyb, bb = x.to(bf), w.to(bf), gy.to(bf), b.to(bf)
        k = w.shape[2]
        conv_args = ([conf['stride']], [conf['padding']], [conf['dilation']], False, [0],
                     conf['groups'])
        d = dict(conf, precision='default')

        def run(entry, x_, w_, gy_, **kw):
            if entry == 'fwd':
                return gc.conv1d_forward(x_, w_, b, slope=slope, **kw)
            if entry == 'dx':
                return gc.conv1d_input_grad(gy_, w_, t, **kw)
            return gc.conv1d_weight_grad(x_, gy_, w.shape, **kw)

        def plain(entry, x_, w_, gy_, **kw):
            if entry == 'fwd':
                return gc.grouped_conv1d_reference(x_, w_, b, slope=slope, **kw)
            if entry == 'dx':
                return gc.conv1d_input_grad_reference(gy_, w_, t, **kw)
            return gc.conv1d_weight_grad_reference(x_, gy_, w.shape, **kw)

        def cudnn_bf16(entry):
            if entry == 'fwd':
                return F.conv1d(xb, wb, bb, stride=conf['stride'], padding=conf['padding'],
                                dilation=conf['dilation'], groups=conf['groups'])
            mask = [entry == 'dx', entry == 'dw', False]
            return torch.ops.aten.convolution_backward(gyb, xb, wb, None, *conv_args,
                                                       mask)[0 if entry == 'dx' else 1]

        macs = conv_macs(n, w.shape[0], w.shape[1], k, conf['stride'], conf['padding'],
                         conf['dilation'], t, y32.shape[2])
        moved = {'fwd': x.numel() + w.numel() + y32.numel(),
                 'dx': gy.numel() + w.numel() + x.numel(),
                 'dw': x.numel() + gy.numel() + w.numel()}
        line = {}
        cudnn = cudnn_routes(x, w, b, gy, conf, slope)
        for e in entries:
            highest = plain(e, x, w, gy, **conf)
            for r, (x_, w_, gy_) in (('default', (x, w, gy)), ('bf16', (xb, wb, gyb))):
                got, ref = run(e, x_, w_, gy_, **d), plain(e, x_, w_, gy_, **d)
                torch.cuda.synchronize()
                assert got.shape == ref.shape and got.dtype == ref.dtype, (name, e, r)
                scale = float(ref.float().abs().max())
                err = max_err(got.float(), ref.float())
                tol = (GC_FWD_TOL if e == 'fwd' else GC_GRAD_TOL) * scale + \
                    (bf16_ulp(scale) if r == 'bf16' else 0.0)
                ratio = rms(got.float() - ref.float()) / max(rms(got.float() - highest), 1e-300)
                errs[e, r] = max(errs[e, r], err / scale)
                ratios[e, r] = max(ratios[e, r], ratio)
                line['%s_%s' % (e, r)] = '%.3g/%.3g' % (err / scale, ratio)
                assert err <= tol, (name, e, r, err, tol)
                assert ratio <= MODE_RMS_RATIO, (name, e, r, ratio)
            ms = dict(zip(('default', 'plain'), paired_ms(
                lambda: plain(e, x, w, gy, **d), lambda: run(e, x, w, gy, **d), 3)[:2]))
            ms['bf16'] = cuda_ms(lambda: run(e, xb, wb, gyb, **d), 3)
            ms['plain_bf16'] = cuda_ms(lambda: plain(e, xb, wb, gyb, **d), 3)
            ms['highest'] = cuda_ms(lambda: run(e, x, w, gy, **conf), 3)
            ms['cudnn_bf16'] = cuda_ms(lambda: cudnn_bf16(e), 3)
            ref = plain(e, x, w, gy, **d)
            scale = float(ref.abs().max())
            got = cudnn[e]()
            torch.cuda.synchronize()
            err = max_err(got, ref)
            ratio = rms(got - ref) / max(rms(got - highest), 1e-300)
            cudnn_errs[e] = max(cudnn_errs[e], err / scale)
            cudnn_ratios[e] = max(cudnn_ratios[e], ratio)
            line['%s_cudnn' % e] = '%.3g/%.3g' % (err / scale, ratio)
            assert got.shape == ref.shape, (name, e)
            assert err <= (GC_FWD_TOL if e == 'fwd' else GC_GRAD_TOL) * scale, (
                name, e, err / scale)
            assert ratio <= MODE_RMS_RATIO, (name, e, ratio)
            ms['cudnn_default'] = cuda_ms(cudnn[e], 3)
            for part in parts:
                for key_ in keys:
                    sums[part][e][key_] += ms[key_]
                work[part][e][0] += 2.0 * macs
                work[part][e][1] += moved[e]
            line[e + '_ms'] = '/'.join('%.3f' % ms[key_] for key_ in keys)
        log('k6_modes', layer=name, geometry='%d->%d k%d s%d g%d T%d' % (
            x.shape[1], w.shape[0], k, conf['stride'], conf['groups'], t), batch=n, **line)
    del layers
    # bounds: every product at the bf16 tensor-core peak, or the bytes at the
    # tensors' dtype (float32: 4, bfloat16: 2) over the memory rate
    bounds = {(part, e, r): bf16_bound(work[part][e][0], (4 if r == 'default' else 2)
                                       * work[part][e][1], 1)
              for part in sums for e in entries for r in CRITIC_MODES}
    for part in sums:
        log('time', card=repr(card), what='k6_modes_%s_one_call_each' % part,
            order='/'.join(keys),
            **{'%s_ms' % e: '/'.join('%.3f' % sums[part][e][key_] for key_ in keys)
               for e in entries},
            **{'%s_%s_bound_ms' % (e, r): '%.3f(%s)' % bounds[part, e, r]
               for e in entries for r in CRITIC_MODES},
            **{'%s_gflop' % e: '%.1f' % (work[part][e][0] / 1e9) for e in entries})
    log('k6_modes', worst_rel_err=' '.join('%s_%s=%.3g' % (e, r, errs[e, r])
                                           for e in entries for r in CRITIC_MODES),
        worst_rms_ratio=' '.join('%s_%s=%.3g' % (e, r, ratios[e, r])
                                 for e in entries for r in CRITIC_MODES))
    log('cudnn_default', what='critics',
        worst_rel_err=' '.join('%s=%.3g' % (e, cudnn_errs[e]) for e in entries),
        worst_rms_ratio=' '.join('%s=%.3g' % (e, cudnn_ratios[e]) for e in entries))

    # 18b the folded MSD against the unfolded one on both routes, fp32
    #     'highest': every score and map, and every parameter's gradient of a
    #     loss over all of them, at the critic phase's 32 x 8192 batch
    for kernel in (False, True):
        msd = build_gan(dev, 0, kernel)[2]
        runs = []
        for apply in (msd, lambda w: disc.msd_apply_folded(msd, w)):
            msd.zero_grad()
            outs = apply(both)
            sum(torch.mean(s_ ** 2) + sum(torch.mean(f.abs()) for f in feats)
                for s_, feats in outs).backward()
            runs.append(([(s_.detach(), [f.detach() for f in feats]) for s_, feats in outs],
                         {k_: p.grad.clone() for k_, p in msd.named_parameters()}))
        (ref, g_ref), (got, g_got) = runs
        out_err = max(float(((a - b).abs() - FOLD_TOL * b.abs()).max())
                      for (s_g, f_g), (s_r, f_r) in zip(got, ref)
                      for a, b in [(s_g, s_r)] + list(zip(f_g, f_r)))
        grad_err = max(float(((g_got[k_] - g).abs() - FOLD_GRAD_RTOL * g.abs()).max())
                       for k_, g in g_ref.items())
        log('msd_folded', route='k6' if kernel else 'cudnn', outputs_excess=
            '%.3g' % out_err, grads_excess='%.3g' % grad_err)
        assert out_err <= FOLD_TOL and grad_err <= FOLD_GRAD_ATOL, (kernel, out_err, grad_err)
        del msd, runs, ref, got, g_ref, g_got
    del both

    # 18c the recipe's step: HiFiGANTrainer(...).run() at full width on the K6
    #     route for 3 steps and a validation batch, the critics in 'default',
    #     then also folded, then on bf16 activations, launch counts from zero
    #     per route; one step card vs CPU; then the step time and peak memory
    #     of each, in turns with the critics at 'highest' (phase 8.5's route)
    configs = {'default': ({'precision': 'default'}, False),
               'default_folded': ({'precision': 'default'}, True),
               'default_bf16': ({'precision': 'default', 'compute_dtype': 'bf16'}, False)}
    launches = {r: [0, 0, 0] for r in CRITIC_MODES}
    counters = (gc.conv1d_forward, gc.conv1d_input_grad, gc.conv1d_weight_grad)
    for cname, (mode, folded) in configs.items():
        route = 'bf16' if mode.get('compute_dtype') else 'default'
        work_dir = tempfile.mkdtemp(prefix='chip_smoke_modes_')
        try:
            models = build_gan(dev, 0, kernel=True, **mode)
            gc.reset_launches()
            run = make_trainer(models, dev, work_dir, train=ToneStream(3), valid=ToneStream(1),
                               max_step=3, valid_max_step=1, save_interval=3, log_interval=1,
                               msd_folded=folded)
            best = run.run()
            torch.cuda.synchronize()
            got = {r: tuple(c.launches_by_mode[r] for c in counters)
                   for r in ('highest',) + CRITIC_MODES}
            train = {s_: m for tag, s_, m in run.logged if tag == 'train'}
            assert sorted(train) == [1, 2, 3], sorted(train)
            assert all(np.isfinite(m[k_]) for m in train.values() for k_ in LOSSES), train
            assert np.isfinite(best), best
            gen_, mpd_, msd_ = models
            want = {'highest': ups_gc_launches(gen_, 3, 1),
                    route: tuple(3 * c for c in critic_gc_launches(mpd_, msd_, folded)),
                    ({'default', 'bf16'} - {route}).pop(): (0, 0, 0)}
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        for s_ in sorted(train):
            log('train', route='k6_' + cname, step=s_,
                **{k_: '%.6f' % train[s_][k_] for k_ in LOSSES})
        log('counts', route='k6_' + cname, **{r: '%d/%d/%d' % got[r] for r in got},
            expected=' '.join('%s=%d/%d/%d' % ((r,) + want[r]) for r in got),
            best_valid_mel_l1='%.6f' % best)
        assert got == want and min(got[route]) > 0, (cname, got, want)
        for i in range(3):
            launches[route][i] += got[route][i]
        del run, models

        loss_rel, (grad_rel, worst), shown, n_params = split_step_pair(
            [('cpu', True), (dev, True)], msd_folded=folded, **mode)
        log('card_cpu', route='k6_' + cname, losses=shown, worst_loss_rel='%.3g' % loss_rel,
            worst_grad_rel='%.3g' % grad_rel, worst_grad_param=worst, params=n_params)
        assert loss_rel <= MODE_STEP_RTOL and grad_rel <= MODE_STEP_GRAD_TOL, \
            (cname, loss_rel, worst, grad_rel)

    real = torch.from_numpy(tones(np.random.default_rng(6), BATCH, SEG)).to(dev)[:, None, :]
    for cname, (mode, folded) in dict(highest=({}, False), **configs).items():
        trainer = make_trainer(build_gan(dev, 0, kernel=True, **mode), dev,
                               tempfile.mkdtemp(prefix='chip_smoke_t_'), max_step=1,
                               valid_max_step=1, save_interval=1, log_interval=1,
                               msd_folded=folded)
        shutil.rmtree(trainer.save_dir, ignore_errors=True)
        steps_s, step_ms, disc_ms, gen_ms, peak_gb = time_train_steps(trainer, real, 6)
        del trainer
        log('time', card=repr(card), what='train_step_16x8192_k6_' + cname,
            step_ms='%.2f' % step_ms, steps_per_s='%.3f' % steps_s,
            disc_phase_ms='/'.join('%.2f' % v for v in disc_ms),
            gen_phase_ms='/'.join('%.2f' % v for v in gen_ms),
            peak_memory_gb='%.2f' % peak_gb,
            phase8_k6_step_ms='%.2f' % kernel_route.step_ms['in_memory_8_5'],
            phase8_k6_peak_memory_gb='%.2f' % kernel_route.peak_gb,
            cudnn_step_ms='%.2f' % cudnn_step[1], cudnn_peak_memory_gb='%.2f' % cudnn_step[4])
    log('critic_modes', seconds='%.1f' % (time.perf_counter() - t_start))
    replaces = {'fwd': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:414',
                'dx': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:414',
                'dw': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:763'}
    return [{'name': 'grouped_conv_%s_%s' % (e, r), 'route': 'cuda', 'source': gc.SOURCE,
             'replaces': replaces[e], 'precision': 'default',
             'dtype': 'bfloat16' if r == 'bf16' else 'float32',
             'launches': launches[r][i], 'max_abs_err': errs[e, r],
             'ms': sums['critics'][e][r], 'plain_ms': sums['critics'][e][
                 'plain' if r == 'default' else 'plain_bf16'],
             'bound_ms': bounds['critics', e, r][0], 'bound_by': bounds['critics', e, r][1],
             'tc_bound_ms': bounds['critics', e, r][0],
             'highest_ms': sums['critics'][e]['highest'],
             'folded_ms': sums['folded'][e][r],
             'cudnn_bf16_ms': sums['critics'][e]['cudnn_bf16'],
             # the same function in one library call: on float32 tensors the
             # repaired cuDNN route, on bfloat16 ones cuDNN's bf16 conv
             'library_ms': sums['critics'][e][
                 'cudnn_default' if r == 'default' else 'cudnn_bf16']}
            for i, e in enumerate(entries) for r in CRITIC_MODES]

# phase 19: JAX's recipe modes, the generator in 'default' (K6 or the
# repaired cuDNN route), the critics in 'default', K2 / K4 in 'bf16x3'
GEN_MODES = {'highest': dict(precision='highest', gen_precision='highest',
                             mel_precision='highest'),
             'jax': dict(precision='default', gen_precision='default',
                         mel_precision='bf16x3')}
V1_RESBLOCKS = ((256, 256), (128, 2048))   # v1's resblock channels and samples at 16 x 8192
# The recipe's step in JAX's modes, card vs CPU: the losses and the critics'
# gradients at phase 18's bounds (MODE_STEP_RTOL, MODE_STEP_GRAD_TOL); the
# generator's gradients, whose cotangents take a bf16 rounding at each of its
# 78 convs after the critics' 54, by their worst and their median leaf. On an
# NVIDIA H100 80GB HBM3 at 700 W: at most 0.060 (a resblock bias) and 0.030;
# the control, the card's generator left at 'highest', 0.131 and 0.068. Each
# bound sits about 1.5x from both readings, and the control must exceed both
GEN_MODE_GRAD_TOL = 0.09
GEN_MODE_GRAD_MEDIAN_TOL = 0.045


def gen_layers(gen, mel):
    """Every conv of ``gen`` with its input on ``mel``: [(name, transposed,
    input, weight, bias, conv keywords, slope)]."""
    import torch
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import (WNConv1d,
                                                                  WNConvTranspose1d)
    layers, hooks = [], []
    for name, m in gen.named_modules():
        if isinstance(m, (WNConv1d, WNConvTranspose1d)):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, _n=name: layers.append((_n, mod, inp[0].contiguous()))))
    with torch.no_grad():
        gen(mel)
    for h in hooks:
        h.remove()
    out = []
    for name, m, x in layers:
        convt = isinstance(m, WNConvTranspose1d)
        conf = dict(stride=m.stride, padding=m.padding) if convt else dict(
            stride=m.stride, padding=m.padding, groups=m.groups, dilation=m.dilation)
        out.append((name, convt, x, m.folded_weight().detach(), m.bias.detach(), conf,
                    None if convt else m.fused_slope))
    return out


def v1_layers(dev, rng):
    """v1's distinct resblock geometries at the recipe's 16 x 8192 output:
    C = 256 (256 samples) and 128 (2048), k 3 / 7 / 11, dilations 1 / 3 / 5,
    the mid-block slope fused, on seeded inputs and weights."""
    import torch
    out = []
    for c, t in V1_RESBLOCKS:
        for k in (3, 7, 11):
            for d in (1, 3, 5):
                x = torch.randn((BATCH, c, t), generator=rng, device=dev) * 0.5
                w = torch.randn((c, c, k), generator=rng, device=dev) * (c * k) ** -0.5
                b = torch.randn((c,), generator=rng, device=dev) * 0.05
                out.append(('v1.C%d.k%d.d%d' % (c, k, d), False, x, w, b,
                            dict(stride=1, padding=d * (k - 1) // 2, groups=1, dilation=d),
                            0.1))
    return out


def gen_modes_path(dev, card):
    """Phase 19: the generator's modes and the recipe in JAX's. Returns the
    JSON entries of the three grouped-conv entry points on the generator in
    'default' and of K4 in its modes."""
    import torch
    import torch.nn.functional as F
    from pytorch_sound_tpu_torch.models.vocoders import discriminators as disc
    from pytorch_sound_tpu_torch.models.vocoders import hifi_gan as hg
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm

    t_start = time.perf_counter()
    # 19a every conv of v2's generator on its real inputs at the recipe's 16 x
    #     8192 and v1's distinct resblock geometries: K6 in 'default' and the
    #     repaired cuDNN route against the plain version of
    #     the mode, forward / dx / dw at GC_FWD_TOL / GC_GRAD_TOL and nearer
    #     it than 'highest' by RMS; per-layer ms of K6 and cuDNN in both modes
    real = torch.from_numpy(tones(np.random.default_rng(19), BATCH, SEG)).to(dev)
    with torch.no_grad():
        mel = lm.fused_hifigan_mel(real)
    gen = build_gan(dev, 0, kernel=True, gen_convs=True)[0]
    layers = gen_layers(gen, mel) + v1_layers(dev, torch.Generator(device=dev).manual_seed(9))
    del gen
    rng = torch.Generator(device=dev).manual_seed(19)
    entries = ('fwd', 'dx', 'dw')
    routes = ('k6', 'cudnn')
    errs = {(e, r): 0.0 for e in entries for r in routes}
    ratios = dict(errs)
    keys = ('k6_default', 'k6_highest', 'cudnn_default', 'cudnn_highest', 'plain')
    sums = {part: {e: dict.fromkeys(keys, 0.0) for e in entries} for part in ('v2', 'v1')}
    work = {e: [0.0, 0.0] for e in entries}         # v2's FLOPs and elements
    for name, convt, x, w, b, conf, slope in layers:
        part = 'v1' if name.startswith('v1.') else 'v2'
        t = x.shape[2]
        if convt:
            y32 = gc.conv_transpose1d_reference(x, w, b, **conf)
        else:
            y32 = gc.grouped_conv1d_reference(x, w, b, slope=slope, **conf)
        gy = torch.randn(y32.shape, generator=rng, device=dev)

        def k6(entry, precision):
            kw = dict(conf, precision=precision)
            if convt:
                return {'fwd': lambda: gc.conv1d_input_grad(x, w, y32.shape[2], b, **kw),
                        'dx': lambda: gc.conv1d_forward(gy, w, **kw),
                        'dw': lambda: gc.conv1d_weight_grad(gy, x, w.shape, **kw)}[entry]
            return {'fwd': lambda: gc.conv1d_forward(x, w, b, slope=slope, **kw),
                    'dx': lambda: gc.conv1d_input_grad(gy, w, t, **kw),
                    'dw': lambda: gc.conv1d_weight_grad(x, gy, w.shape, **kw)}[entry]

        def plain(entry, precision):
            kw = dict(conf, precision=precision)
            if convt:
                return {'fwd': lambda: gc.conv_transpose1d_reference(x, w, b, **kw),
                        'dx': lambda: gc.grouped_conv1d_reference(gy, w, **kw),
                        'dw': lambda: gc.conv1d_weight_grad_reference(gy, x, w.shape, **kw)
                        }[entry]
            return {'fwd': lambda: gc.grouped_conv1d_reference(x, w, b, slope=slope, **kw),
                    'dx': lambda: gc.conv1d_input_grad_reference(gy, w, t, **kw),
                    'dw': lambda: gc.conv1d_weight_grad_reference(x, gy, w.shape, **kw)
                    }[entry]

        cudnn = cudnn_routes(x, w, b, gy, conf, slope, convt)
        cudnn_hi = cudnn_routes(x, w, b, gy, conf, None, convt, precision='highest')
        if convt:       # the mirror conv's products: x is its cotangent
            macs = conv_macs(BATCH, x.shape[1], w.shape[1], w.shape[2], conf['stride'],
                             conf['padding'], 1, y32.shape[2], t)
        else:
            macs = conv_macs(BATCH, w.shape[0], w.shape[1], w.shape[2], conf['stride'],
                             conf['padding'], conf['dilation'], t, y32.shape[2])
        moved = {'fwd': x.numel() + w.numel() + y32.numel(),
                 'dx': gy.numel() + w.numel() + x.numel(),
                 'dw': x.numel() + gy.numel() + w.numel()}
        line = {}
        for e in entries:
            ref, highest = plain(e, 'default')(), plain(e, 'highest')()
            scale = float(ref.abs().max())
            tol = (GC_FWD_TOL if e == 'fwd' else GC_GRAD_TOL) * scale
            for r, fn in (('k6', k6(e, 'default')), ('cudnn', cudnn[e])):
                got = fn()
                torch.cuda.synchronize()
                err = max_err(got, ref)
                ratio = rms(got - ref) / max(rms(got - highest), 1e-300)
                errs[e, r] = max(errs[e, r], err / scale)
                ratios[e, r] = max(ratios[e, r], ratio)
                line['%s_%s' % (e, r)] = '%.3g/%.3g' % (err / scale, ratio)
                assert got.shape == ref.shape and err <= tol, (name, e, r, err, tol)
                assert ratio <= MODE_RMS_RATIO, (name, e, r, ratio)
            ms = {'k6_default': cuda_ms(k6(e, 'default'), 3),
                  'plain': cuda_ms(plain(e, 'default'), 3),
                  'k6_highest': cuda_ms(k6(e, 'highest'), 3)}
            ms['cudnn_highest'] = cuda_ms(cudnn_hi[e], 3)
            ms['cudnn_default'] = cuda_ms(cudnn[e], 3)
            for key_ in keys:
                sums[part][e][key_] += ms[key_]
            if part == 'v2':
                work[e][0] += 2.0 * macs
                work[e][1] += moved[e]
            line[e + '_ms'] = '/'.join('%.3f' % ms[key_] for key_ in keys)
        log('gen_modes', layer=name, seconds='%.1f' % (time.perf_counter() - t_start),
            geometry='%d->%d k%d s%d d%d T%d' % (
            x.shape[1], y32.shape[1], w.shape[2], conf['stride'], conf.get('dilation', 1), t),
            **line)
    del layers, cudnn, cudnn_hi
    bounds = {e: bf16_bound(work[e][0], 4 * work[e][1], 1) for e in entries}
    for part in sums:
        log('time', card=repr(card), what='gen_layers_%s_one_call_each' % part,
            order='/'.join(keys),
            **{'%s_ms' % e: '/'.join('%.3f' % sums[part][e][key_] for key_ in keys)
               for e in entries},
            **({'%s_bound_ms' % e: '%.4f(%s)' % bounds[e] for e in entries}
               if part == 'v2' else {}))
    log('gen_modes',
        worst_rel_err=' '.join('%s_%s=%.3g' % (e, r, errs[e, r]) for e in entries
                               for r in routes),
        worst_rms_ratio=' '.join('%s_%s=%.3g' % (e, r, ratios[e, r]) for e in entries
                                 for r in routes))

    #     WNConv2d in 'default' (the repaired route, 2-D) against the plain
    #     version of the mode, forward / dx / dw
    x2 = torch.randn((8, 32, 1024, 7), generator=rng, device=dev)
    conv2 = disc.WNConv2d(32, 64, (5, 1), stride=(3, 1), padding=(2, 0),
                          precision='default').to(dev)
    w2 = conv2.folded_weight().detach()
    y2 = conv2(x2)
    g2 = torch.randn(y2.shape, generator=rng, device=dev)
    dx2, dw2 = torch.autograd.grad(hg.rounded_conv(x2.requires_grad_(True), w2.requires_grad_(
        True), conv2.bias.detach(), stride=(3, 1), padding=(2, 0)), (x2, w2), g2)
    xo, wo, go = gc._operands('default', x2.detach(), w2.detach(), g2)
    xh, wh = x2.detach(), w2.detach()
    for e, got, ref, hi in (
            ('fwd', y2, F.conv2d(xo, wo, conv2.bias, stride=(3, 1), padding=(2, 0)),
             F.conv2d(xh, wh, conv2.bias, stride=(3, 1), padding=(2, 0))),
            ('dx', dx2, torch.nn.grad.conv2d_input(xh.shape, wo, go, (3, 1), (2, 0)),
             torch.nn.grad.conv2d_input(xh.shape, wh, g2, (3, 1), (2, 0))),
            ('dw', dw2, torch.nn.grad.conv2d_weight(xo, wh.shape, go, (3, 1), (2, 0)),
             torch.nn.grad.conv2d_weight(xh, wh.shape, g2, (3, 1), (2, 0)))):
        scale = float(ref.abs().max())
        err, ratio = max_err(got.detach(), ref) / scale, rms(got.detach() - ref) / rms(
            got.detach() - hi)
        log('wnconv2d_default', entry=e, rel_err='%.3g' % err, rms_ratio='%.3g' % ratio)
        assert err <= (GC_FWD_TOL if e == 'fwd' else GC_GRAD_TOL) and \
            ratio <= MODE_RMS_RATIO, (e, err, ratio)
    del x2, y2, g2, dx2, dw2, conv2
    log('gen_modes', what='19a', seconds='%.1f' % (time.perf_counter() - t_start))

    # 19b the generator's forward + backward at 16 x 8192 per route and mode,
    #     in turns, with its K6 launches per mode
    gen_ms = {}
    gr = torch.randn((BATCH, 1, SEG), generator=rng, device=dev)
    for route in ('cudnn', 'k6'):
        gens = {m: build_gan(dev, 0, kernel=route == 'k6', gen_convs=True,
                             gen_precision=m)[0] for m in ('highest', 'default')}

        def fwd_bwd(m):
            return lambda: gens[m](mel).backward(gr)
        for m in ('highest', 'default'):
            gc.reset_launches()
            fwd_bwd(m)()
            torch.cuda.synchronize()
            counts = {r: '%d/%d/%d' % tuple(c.launches_by_mode[r] for c in (
                gc.conv1d_forward, gc.conv1d_input_grad, gc.conv1d_weight_grad))
                for r in ('highest', 'default')}
            log('counts', what='gen_fwd_bwd_%s_%s' % (route, m), **counts)
            if route == 'k6':
                assert counts[m] != '0/0/0' and counts[
                    ({'highest', 'default'} - {m}).pop()] == '0/0/0', counts
        k_d, k_h = paired_ms(fwd_bwd('highest'), fwd_bwd('default'), 5)[:2]
        gen_ms[route] = (k_h, k_d)
        log('time', card=repr(card), what='gen_fwd_bwd_16x8192_%s' % route,
            highest_ms='%.2f' % k_h, default_ms='%.2f' % k_d)
        del gens

    # 19c the recipe in JAX's modes (generator and critics 'default', K2 / K4
    #     'bf16x3') for 3 steps and a validation batch on each route, launch
    #     counts from zero per mode; one step card vs CPU at phase 18's bounds
    k4_counts = {m: 0 for m in lm.PRECISIONS}
    k6_counts = [0, 0, 0]
    jax_step = dict(mel_precision='bf16x3', precision='default', gen_precision='default',
                    gen_convs=True)

    def family_worst(rels):
        """{'gen' / 'critics': (name, worst gradient difference, median)}."""
        out = {}
        for fam, keep in (('gen', lambda k: k.startswith('gen.')),
                          ('critics', lambda k: not k.startswith('gen.'))):
            name = max((k for k in rels if keep(k)), key=rels.get)
            out[fam] = (name, rels[name], float(np.median([v for k, v in rels.items()
                                                            if keep(k)])))
        return out

    def shown_worst(worst):
        return {'worst_%s_grad' % f: '%.3g(%s)' % worst[f][1::-1] for f in worst} | {
            'median_%s_grad' % f: '%.3g' % worst[f][2] for f in worst}
    for route in ('k6', 'cudnn'):
        mode = GEN_MODES['jax']
        work_dir = tempfile.mkdtemp(prefix='chip_smoke_gen_modes_')
        try:
            models = build_gan(dev, 0, kernel=route == 'k6', precision=mode['precision'],
                               gen_precision=mode['gen_precision'], gen_convs=True)
            gc.reset_launches()
            for fn in (lm.fused_log_mel, lm.fused_hifigan_mel_trainable):
                fn.launches_by_mode = dict.fromkeys(lm.PRECISIONS, 0)
            bwd0 = lm.fused_hifigan_mel_trainable.bwd_launches
            run = make_trainer(models, dev, work_dir, train=ToneStream(3), valid=ToneStream(1),
                               max_step=3, valid_max_step=1, save_interval=3, log_interval=1,
                               mel_precision=mode['mel_precision'])
            best = run.run()
            torch.cuda.synchronize()
            got = {r: tuple(c.launches_by_mode[r] for c in (
                gc.conv1d_forward, gc.conv1d_input_grad, gc.conv1d_weight_grad))
                for r in gc.ROUTES}
            mels = (dict(lm.fused_log_mel.launches_by_mode),
                    dict(lm.fused_hifigan_mel_trainable.launches_by_mode),
                    lm.fused_hifigan_mel_trainable.bwd_launches - bwd0)
            train = {s_: m for tag, s_, m in run.logged if tag == 'train'}
            assert sorted(train) == [1, 2, 3], sorted(train)
            assert all(np.isfinite(m[k_]) for m in train.values() for k_ in LOSSES), train
            assert np.isfinite(best), best
            gen_, mpd_, msd_ = models
            k6_want = tuple(g + 3 * c for g, c in zip(gen_gc_launches(gen_, 3, 1),
                                                     critic_gc_launches(mpd_, msd_)))
            want = {'highest': (0, 0, 0), 'bf16': (0, 0, 0),
                    'default': k6_want if route == 'k6' else (0, 0, 0)}
        finally:
            shutil.rmtree(work_dir, ignore_errors=True)
        for s_ in sorted(train):
            log('train', route=route + '_jax_modes', step=s_,
                **{k_: '%.6f' % train[s_][k_] for k_ in LOSSES})
        log('counts', route=route + '_jax_modes', **{r: '%d/%d/%d' % got[r] for r in got},
            expected=' '.join('%s=%d/%d/%d' % ((r,) + want[r]) for r in got),
            k2_by_mode=mels[0], k4_by_mode=mels[1], k4_bwd=mels[2],
            best_valid_mel_l1='%.6f' % best)
        # K2: the real mel of each step and of the validation batch, and K4's
        # forward of each fake (3 steps, 1 validation batch); K4's backward
        # once a step; every forward in 'bf16x3'
        assert got == want, (route, got, want)
        assert mels == ({'highest': 0, 'bf16x3': 8, 'default': 0},
                        {'highest': 0, 'bf16x3': 4, 'default': 0}, 3), mels
        for m in lm.PRECISIONS:
            k4_counts[m] += mels[1][m]
        if route == 'k6':
            k6_counts = list(got['default'])
        del run, models

        loss_rel, _, shown, n_params, rels = split_step_pair(
            [('cpu', route == 'k6'), (dev, route == 'k6')], detail=True, **jax_step)
        worst = family_worst(rels)
        log('card_cpu', route=route + '_jax_modes', losses=shown,
            worst_loss_rel='%.3g' % loss_rel, params=n_params, **shown_worst(worst),
            gen_grads_above_critic_bound=sum(v > MODE_STEP_GRAD_TOL for k, v in rels.items()
                                             if k.startswith('gen.')))
        assert loss_rel <= MODE_STEP_RTOL, (route, loss_rel)
        assert worst['critics'][1] <= MODE_STEP_GRAD_TOL, (route, worst)
        assert worst['gen'][1] <= GEN_MODE_GRAD_TOL, (route, worst)
        assert worst['gen'][2] <= GEN_MODE_GRAD_MEDIAN_TOL, (route, worst)
    # the spread between two right answers on the card: the same step on the
    # K6 route against the cuDNN route (the same mode, other sum orders)
    loss_rel, _, shown, _, rels = split_step_pair([(dev, False), (dev, True)], detail=True,
                                                  **jax_step)
    worst = family_worst(rels)
    log('card_routes', what='k6_vs_cudnn_jax_modes', worst_loss_rel='%.3g' % loss_rel,
        **shown_worst(worst))

    # controls: the CPU in JAX's modes against a card step that leaves a
    # rounding of the generator's mode out. Its convs at 'highest' must read
    # above both generator bounds. The cuDNN route's backward not rounding
    # the cotangent on the card is logged only: the step reads it as a right
    # answer (0.055 / 0.029 on an H100), and 19a's dx / dw checks hold it
    rounded = hg._RoundedConv

    class CardCotangentUnrounded(rounded):
        @staticmethod
        def backward(ctx, g):
            if not g.is_cuda:
                return rounded.backward(ctx, g)
            xb, wb = ctx.saved_tensors
            need_x, need_w = ctx.needs_input_grad[:2]
            x = xb.float() if need_w else g.new_empty(ctx.shapes[0])
            w = wb.float() if need_x else g.new_empty(ctx.shapes[1])
            dx, dw, _ = torch.ops.aten.convolution_backward(
                g.contiguous(), x, w, None, *ctx.conf, [need_x, need_w, False])
            db = g.sum(dim=[d for d in range(g.ndim) if d != 1])
            return dx, dw, db, None
    controls = {}
    for what, card_mode in (('gen_highest', dict(gen_precision='highest')),
                            ('cotangent_unrounded', {})):
        hg._RoundedConv = CardCotangentUnrounded if what == 'cotangent_unrounded' else rounded
        try:
            loss_rel, _, shown, _, rels = split_step_pair(
                [('cpu', False), (dev, False, card_mode)], detail=True, **jax_step)
        finally:
            hg._RoundedConv = rounded
        controls[what] = family_worst(rels)
        log('card_cpu', control=what, route='cudnn_jax_modes', losses=shown,
            worst_loss_rel='%.3g' % loss_rel, **shown_worst(controls[what]))
    assert controls['gen_highest']['gen'][1] > GEN_MODE_GRAD_TOL and \
        controls['gen_highest']['gen'][2] > GEN_MODE_GRAD_MEDIAN_TOL, controls
    log('gen_modes', what='19c', seconds='%.1f' % (time.perf_counter() - t_start))

    # 19d the step time and peak memory in JAX's modes against 'highest', in
    #     turns, on each route
    step = {}
    for route, name in (('k6', 'highest'), ('k6', 'jax'), ('cudnn', 'jax'), ('cudnn', 'highest')):
        mode = GEN_MODES[name]
        trainer = make_trainer(build_gan(dev, 0, kernel=route == 'k6', gen_convs=True,
                                         precision=mode['precision'],
                                         gen_precision=mode['gen_precision']), dev,
                               tempfile.mkdtemp(prefix='chip_smoke_t_'), max_step=1,
                               valid_max_step=1, save_interval=1, log_interval=1,
                               mel_precision=mode['mel_precision'])
        shutil.rmtree(trainer.save_dir, ignore_errors=True)
        steps_s, step_ms, disc_ms, gen_ph, peak_gb = time_train_steps(
            trainer, real[:, None, :], 5)
        del trainer
        step[route, name] = step_ms
        log('time', card=repr(card), what='train_step_16x8192_%s_%s' % (route, name),
            step_ms='%.2f' % step_ms, steps_per_s='%.3f' % steps_s,
            disc_phase_ms='/'.join('%.2f' % v for v in disc_ms),
            gen_phase_ms='/'.join('%.2f' % v for v in gen_ph), peak_memory_gb='%.2f' % peak_gb)

    # K4 in each mode at the recipe's 16 x 8192: the same fp64 kernel (bit for
    # bit 'highest'), against the plain version in fp64, timed
    k4_err, k4_ms = {}, {}
    fake = real * 0.5
    ref64 = mel_ops.hifigan_mel_spectrogram(fake.double())
    hi = lm.fused_hifigan_mel_trainable(fake, 'highest')
    for m in lm.PRECISIONS:
        out = lm.fused_hifigan_mel_trainable(fake, m)
        torch.cuda.synchronize()
        k4_err[m] = max_err(out.double(), ref64)
        assert torch.equal(out, hi) and k4_err[m] <= MEL_TOL, (m, k4_err[m])
        k4_ms[m] = cuda_ms(lambda m=m: lm.fused_hifigan_mel_trainable(fake, m), 10)
    k4_plain = cuda_ms(lambda: mel_ops.hifigan_mel_spectrogram(fake), 10)
    consts = lm._constants(SR, 1024, 1024, 80, 0.0, 8000.0, str(dev))
    k4_bound = bound(*logmel_work(*fake.shape, consts.mel_w.shape[1],
                                  int((consts.mel_w != 0).sum())),
                     fp64_peak=PEAK_FP64_CUDA_CORES)
    log('time', card=repr(card), what='k4_modes_16x8192',
        **{'%s_ms' % m: '%.4f' % k4_ms[m] for m in lm.PRECISIONS},
        plain_ms='%.4f' % k4_plain, **{'%s_vs_fp64' % m: '%.3g' % k4_err[m]
                                       for m in lm.PRECISIONS})
    log('gen_modes', seconds='%.1f' % (time.perf_counter() - t_start))
    replaces = {'fwd': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:414',
                'dx': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:414',
                'dw': 'pytorch_sound_tpu/ops/pallas/grouped_conv.py:763'}
    out = [{'name': 'grouped_conv_%s_gen_default' % e, 'route': 'cuda', 'source': gc.SOURCE,
            'replaces': replaces[e], 'precision': 'default',
            'launches': k6_counts[i], 'launches_scope': 'generator and critics',
            'max_abs_err': errs[e, 'k6'], 'ms': sums['v2'][e]['k6_default'],
            'plain_ms': sums['v2'][e]['plain'], 'bound_ms': bounds[e][0],
            'bound_by': bounds[e][1], 'highest_ms': sums['v2'][e]['k6_highest'],
            'v1_ms': sums['v1'][e]['k6_default'], 'library_ms': sums['v2'][e]['cudnn_default'],
            'gen_fwd_bwd_ms': gen_ms['k6'][1],
            'step_ms': step['k6', 'jax'], 'step_highest_ms': step['k6', 'highest']}
           for i, e in enumerate(entries)]
    out.append({'name': 'fused_hifigan_mel_trainable_bf16x3', 'route': 'cuda',
                'source': lm.SOURCE, 'replaces': 'pytorch_sound_tpu/ops/pallas/logmel.py:275',
                'precision': 'bf16x3', 'launches': k4_counts['bf16x3'],
                'max_abs_err': k4_err['bf16x3'], 'ms': k4_ms['bf16x3'], 'plain_ms': k4_plain,
                'bound_ms': k4_bound[0], 'bound_by': k4_bound[1], 'library_ms': None})
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device is available')

    from pytorch_sound_tpu_torch.interface.hifi_gan import InterfaceHifiGAN
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import generator_apply_fused
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import _build
    from pytorch_sound_tpu_torch.ops.cuda import gen_stage as gs
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm

    # 1. device
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    log('device', name=repr(name), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build
    t0 = time.perf_counter()
    _build.library()
    log('build', seconds='%.1f' % (time.perf_counter() - t0),
        sources=','.join(s.split('/')[-1] for s in _build.sources()))

    rng = np.random.default_rng(0)
    errs = {'logmel': 0.0, 'gen_stage': 0.0}

    # 3. log-mel kernel vs plain, both conventions. On white noise (the signal
    #    of tests/test_pallas.py:91-98) against the fp32 plain version; on
    #    harmonic tones, whose quiet bands sit ~64 dB under the partials and
    #    carry fp32 rounding of ~1e-4 in the log, against the plain version
    #    run in fp64 (the kernel's DFT is fp64).
    conventions = {
        'hifigan': (lm.fused_hifigan_mel, mel_ops.hifigan_mel_spectrogram),
        'centered': (
            lambda x: lm.fused_log_mel(x, mel_max=8000.0, min_db=-100.0, max_db=20.0),
            lambda x: mel_ops.log_mel_spectrogram(x, SR, 80, 1024, 1024, 256,
                                                  min_db=-100.0, max_db=20.0,
                                                  mel_max=8000.0)),
    }

    for shape in ((4, 66150), (3, 50001)):
        noise = torch.from_numpy(
            (rng.standard_normal(shape) * 0.2).astype(np.float32)).to(dev)
        tonal = torch.from_numpy(tones(rng, *shape, am=False)).to(dev)
        for conv, (kernel, plain) in conventions.items():
            ker, ref = kernel(noise), plain(noise)
            ker_t, ref_t, ref64 = kernel(tonal), plain(tonal), plain(tonal.double())
            torch.cuda.synchronize()
            assert ker.shape == ref.shape == ker_t.shape, (conv, ker.shape, ref.shape)
            err, err_t = max_err(ker, ref), max_err(ker_t.double(), ref64)
            errs['logmel'] = max(errs['logmel'], err, err_t)
            log('logmel', shape=shape, convention=conv,
                noise_vs_plain='%.3g' % err, tones_vs_fp64='%.3g' % err_t,
                tones_plain_vs_fp64='%.3g' % max_err(ref_t.double(), ref64))
            assert err <= MEL_TOL and err_t <= MEL_TOL, (conv, shape, err, err_t)

    def check_mel(mel, wav, what):
        """Hold a log-mel from the kernel against the plain HiFi-GAN version
        run in fp64 on the same card tensor."""
        ref64 = mel_ops.hifigan_mel_spectrogram(
            torch.as_tensor(wav, dtype=torch.float32, device=dev).double())
        err = max_err(mel.double(), ref64)
        errs['logmel'] = max(errs['logmel'], err)
        log('logmel', what=what, shape=tuple(mel.shape), vs_fp64='%.3g' % err)
        assert mel.shape == ref64.shape and err <= MEL_TOL, (what, mel.shape, err)

    #    short inputs (two frames, and one sample past the pad), every bin
    #    (fmax None), and the other power-of-two n_fft (hop n_fft / 4, the
    #    HiFi-GAN pad and floor), each against the plain version in fp64
    def geometry(n_fft):
        hop = n_fft // 4
        kw = dict(pad=(n_fft - hop) // 2, power_eps=1e-9, log_floor=1e-5)
        filt = mel_ops.cached_mel_filter(SR, n_fft, 80, 0.0, 8000.0)
        return (lambda x: lm.fused_log_mel(x, n_fft=n_fft, win_length=n_fft,
                                           hop_length=hop, mel_max=8000.0, **kw),
                lambda x: mel_ops.log_mel(x, filt, n_fft, hop, n_fft, **kw))

    extra = [('hifigan', conventions['hifigan'], (3, 640)),
             ('hifigan', conventions['hifigan'], (3, 385)),
             ('centered', conventions['centered'], (3, 640)),
             ('centered', conventions['centered'], (3, 513)),
             ('centered_fmax_none', (
                 lambda x: lm.fused_log_mel(x, mel_max=None, min_db=-100.0, max_db=20.0),
                 lambda x: mel_ops.log_mel_spectrogram(x, SR, 80, 1024, 1024, 256,
                                                       min_db=-100.0, max_db=20.0,
                                                       mel_max=None)), (3, 50001)),
             ('n_fft_512', geometry(512), (3, 50001)),
             ('n_fft_2048', geometry(2048), (3, 50001))]
    for conv, (kernel, plain), shape in extra:
        for kind, wav in (('noise', rng.standard_normal(shape) * 0.2),
                          ('tones', tones(rng, *shape, am=False))):
            x = torch.from_numpy(wav.astype(np.float32)).to(dev)
            ker, ref64 = kernel(x), plain(x.double())
            torch.cuda.synchronize()
            err = max_err(ker.double(), ref64)
            errs['logmel'] = max(errs['logmel'], err)
            log('logmel', shape=shape, convention=conv, signal=kind, vs_fp64='%.3g' % err)
            assert ker.shape == ref64.shape and err <= MEL_TOL, (conv, shape, kind, err)

    #    inputs the reflect pad exceeds, by numpy's rule (the HiFi-GAN pad is
    #    384, the centered one 512): both conventions against the plain
    #    version in fp64, JAX's shapes ((3, 80, 0) below one HiFi-GAN frame,
    #    with no launch), reruns bit-identical; K4's backward against autograd
    #    of the fp32 plain version at 384 and 385 (zeros and no launch at 255)
    for t in SHORT_T:
        x = torch.from_numpy((rng.standard_normal((3, t)) * 0.2).astype(np.float32)).to(dev)
        for conv, (kernel, plain) in conventions.items():
            before = lm.fused_log_mel.launches
            ker = kernel(x)
            launched = lm.fused_log_mel.launches - before
            ref64 = plain(x.double())
            rerun = torch.equal(ker, kernel(x))
            torch.cuda.synchronize()
            err = max_err(ker.double(), ref64) if ker.numel() else 0.0
            errs['logmel'] = max(errs['logmel'], err)
            log('logmel', short_t=t, convention=conv, shape=tuple(ker.shape),
                launches=launched, vs_fp64='%.3g' % err, rerun_bit_identical=rerun)
            assert ker.shape == ref64.shape and launched == int(ker.shape[-1] > 0), \
                (conv, t, ker.shape, ref64.shape, launched)
            assert err <= MEL_TOL and rerun, (conv, t, err, rerun)
        if t in (255, 384, 385):
            cot = torch.cos(lm.fused_hifigan_mel(x))
            before = lm.fused_hifigan_mel_trainable.bwd_launches
            got = lm.hifigan_mel_backward(x, cot)
            launched = lm.fused_hifigan_mel_trainable.bwd_launches - before
            ref = lm.hifigan_mel_vjp(x, cot)
            rerun = torch.equal(got, lm.hifigan_mel_backward(x, cot))
            torch.cuda.synchronize()
            err = max_err(got, ref)
            log('k4_bwd', short_t=t, launches=launched, vs_plain='%.3g' % err,
                grad_max='%.3g' % float(ref.abs().max()), rerun_bit_identical=rerun)
            assert err <= GRAD_TOL and rerun and launched == int(cot.numel() > 0), \
                (t, err, rerun, launched)
            assert t > 255 or not bool(got.any())

    enc_wav = torch.from_numpy(tones(rng, 16, 2 * SR)).to(dev)    # timed in phase 6
    enc_mel = lm.fused_hifigan_mel(enc_wav)
    check_mel(enc_mel, enc_wav, 'encode_16x2s')
    #    each frame is computed alone: the batch's log-mel is its items' and a
    #    rerun's, bit for bit
    same = torch.equal(enc_mel, lm.fused_hifigan_mel(enc_wav)) and all(
        torch.equal(enc_mel[i:i + 1], lm.fused_hifigan_mel(enc_wav[i:i + 1].contiguous()))
        for i in range(enc_wav.shape[0]))
    log('logmel', what='batch_vs_items_16x2s', bit_identical=same)
    assert same

    # 4. generator-stage kernel vs plain, v2 checkpoint, real stage inputs
    iface = InterfaceHifiGAN('hifi_gan_v2', device='cuda')
    gen = iface.decoder
    with torch.inference_mode():
        for batch, frames in ((4, 61), (32, 256)):
            mel = iface.encode(tones(rng, batch, frames * UP))[..., :frames]
            x = gen.conv_pre(mel)
            for i in range(4):
                args = gen.stage_args(i)
                ref = gs.generator_stage_reference(x, **args)
                ker = gs.generator_stage(x, **args)
                torch.cuda.synchronize()
                err = max_err(ker, ref)
                errs['gen_stage'] = max(errs['gen_stage'], err)
                log('stage', batch=batch, frames=frames, stage=i, shape=tuple(ker.shape),
                    max_abs_err='%.3g' % err, ref_max='%.3g' % float(ref.abs().max()))
                assert ker.shape == ref.shape and err <= STAGE_TOL, (batch, i, err)
                x = ref

    # 5. the main path, counters from zero
    gs.reset_launches()
    lm.fused_log_mel.launches = 0
    encodes = decoded_batches = 0

    def encode(wav, what):
        """The interface's encode, held against the fp64 plain version."""
        mel = iface.encode(wav)
        check_mel(mel, wav, what)
        return mel

    mel = encode(am_tones((196, 220, 247, 262), 2 * SR), 'main_4x2s')
    out = iface.decode(mel)
    mel_cycle = encode(out[:, 0, :], 'main_cycle')
    encodes, decoded_batches = encodes + 2, decoded_batches + 1
    torch.cuda.synchronize()
    assert mel.shape == (4, 80, 2 * SR // UP) and out.shape == (4, 1, mel.shape[2] * UP)
    assert bool(torch.isfinite(out).all()) and float(out.abs().max()) <= 1.0
    n = min(mel.shape[-1], mel_cycle.shape[-1]) - 4
    a = mel[..., 2:n].cpu().numpy().ravel()
    b = mel_cycle[..., 2:n].cpu().numpy().ravel()
    corr = float(np.corrcoef(a, b)[0, 1])
    med = float(np.median(np.abs(a - b)))
    log('cycle', mel=tuple(mel.shape), wav=tuple(out.shape), corr='%.4f' % corr,
        median_abs='%.4f' % med, wav_max='%.4f' % float(out.abs().max()))
    assert corr > 0.85 and med < 2.0, (corr, med)

    bench_mel = encode(tones(rng, 32, 256 * UP), 'main_32x256f')[..., :256].contiguous()
    bench_wav = iface.decode(bench_mel)
    card_slice = iface.decode(bench_mel[:2, :, :64])
    encodes, decoded_batches = encodes + 1, decoded_batches + 2
    torch.cuda.synchronize()
    assert bench_wav.shape == (32, 1, 256 * UP) and bool(torch.isfinite(bench_wav).all())
    cpu_slice = InterfaceHifiGAN('hifi_gan_v2', device='cpu').decode(
        bench_mel[:2, :, :64].cpu())
    err = max_err(card_slice.cpu(), cpu_slice)
    log('decode', mel=tuple(bench_mel.shape), wav=tuple(bench_wav.shape),
        card_vs_cpu_max_abs_err='%.3g' % err)
    assert err <= DECODE_TOL, err

    long_mel = encode(tones(rng, 1, 4096 * UP), 'main_1x4096f')[..., :4096].contiguous()
    streamed = iface.decode_streaming(long_mel, chunk_frames=256, overlap_frames=32)
    whole = iface.decode(long_mel)
    encodes, decoded_batches = encodes + 1, decoded_batches + 2
    torch.cuda.synchronize()
    assert streamed.shape == whole.shape == (1, 1, 4096 * UP)
    edge = 10 * UP
    err = max_err(streamed[..., edge:-edge], whole[..., edge:-edge])
    log('stream', mel=tuple(long_mel.shape), interior_max_abs_err='%.3g' % err)
    assert err <= STREAM_TOL, err

    launches = {'gen_stage': gs.launch_count(gs.generator_stage),
                'logmel': lm.fused_log_mel.launches}
    log('counts', gen_stage=launches['gen_stage'], logmel=launches['logmel'],
        decoded_batches=decoded_batches, encodes=encodes)
    assert launches['gen_stage'] == 4 * decoded_batches > 0, launches
    assert launches['logmel'] == encodes > 0, launches

    # 5b. weights written through .data, which leaves their version counters
    #     alone: the next card decode follows the new weights (against the
    #     plain decode of them, on the card), and writing the old ones back
    #     brings back the first decode bit for bit
    def plain_decode(m):
        x = gen.conv_pre(m)
        for i in range(4):
            x = gs.generator_stage_reference(x, **gen.stage_args(i))
        return x

    with torch.inference_mode():
        probe = bench_mel[:4].contiguous()
        first = iface.decode(probe)
    params = list(gen.parameters())
    saved = [p.detach().clone() for p in params]
    versions = [p._version for p in params]
    wrng = torch.Generator(device=dev).manual_seed(5)
    for p in params:
        p.data.copy_(p.data * torch.empty_like(p.data).uniform_(0.7, 1.3, generator=wrng))
    assert versions == [p._version for p in params]
    with torch.inference_mode():
        rewritten, ref = iface.decode(probe), plain_decode(probe)
    err, moved = max_err(rewritten, ref), max_err(rewritten, first)
    for p, old in zip(params, saved):
        p.data.copy_(old)
    with torch.inference_mode():
        back = torch.equal(iface.decode(probe), first)
    torch.cuda.synchronize()
    log('data_write', params=len(params), new_vs_plain='%.3g' % err,
        moved_from_first='%.3g' % moved, restored_bit_identical=back)
    assert err <= DECODE_TOL and moved > 10 * DECODE_TOL and back, (err, moved, back)

    # 6. timings: kernel vs plain, one card, in turns
    enc_frames = 16 * (2 * SR // UP)
    with torch.inference_mode():
        enc_k, enc_p, enc_kr, enc_pr = paired_ms(
            lambda: mel_ops.hifigan_mel_spectrogram(enc_wav),
            lambda: lm.fused_hifigan_mel(enc_wav), 20)
        # torch.stft (cuFFT, fp32) alone on the padded input: a yardstick for
        # the FFT, not the same function
        enc_padded = torch.nn.functional.pad(enc_wav[:, None], (384, 384), mode='reflect')[:, 0]
        hann = torch.hann_window(1024, dtype=torch.float32, device=dev)
        stft_ms = cuda_ms(lambda: torch.stft(enc_padded, 1024, 256, 1024, window=hann,
                                             center=False, return_complex=True), 20)
        dec_k, dec_p, dec_kr, dec_pr = paired_ms(
            lambda: plain_decode(bench_mel), lambda: generator_apply_fused(gen, bench_mel), 10)
        stage_in = [gen.conv_pre(bench_mel)]
        for i in range(3):
            stage_in.append(gs.generator_stage_reference(stage_in[-1], **gen.stage_args(i)))
        per_stage = [paired_ms(
            lambda x=x, i=i: gs.generator_stage_reference(x, **gen.stage_args(i)),
            lambda x=x, i=i: gs.generator_stage(x, **gen.stage_args(i)), 10)[:2]
            for i, x in enumerate(stage_in)]
        st_k = sum(k for k, _ in per_stage)
        st_p = sum(p for _, p in per_stage)
        st_work = [stage_work(x, gen.stage_args(i)) for i, x in enumerate(stage_in)]
        st_bound, st_bound_by = bound(sum(f for f, _ in st_work), 0.0,
                                      sum(b for _, b in st_work))
        # the resblock input of stage i has u_i times the positions of x
        st_tc = tc_bound(sum(f for f, _ in st_work), sum(
            resblock_flops(x.shape[0], x.shape[2] * gen.upsample_rates[i], gen.stage_blocks(i))
            for i, x in enumerate(stage_in)), sum(b for _, b in st_work))
        stream_ms = cuda_ms(lambda: iface.decode_streaming(long_mel), 5)
        torch_split_ms, kernel_split_ms, dec_device_ms = split_ms(
            gen, lambda: generator_apply_fused(gen, bench_mel))
    dec_samples = 32 * 256 * UP
    log('time', card=repr(card), what='encode_16x2s',
        kernel_frames_per_s='%.0f' % (enc_frames / enc_k * 1e3),
        plain_frames_per_s='%.0f' % (enc_frames / enc_p * 1e3),
        kernel_ms='%.4f,%.4f' % enc_kr, plain_ms='%.4f,%.4f' % enc_pr,
        stft_ms='%.4f' % stft_ms, pr9_recorded_kernel_ms=PR9_MS['k2_encode_16x2s'],
        pr9_recorded_plain_ms=PR9_MS['k2_plain_encode_16x2s'])
    log('time', card=repr(card), what='decode_32x256',
        kernel_samples_per_s='%.0f' % (dec_samples / dec_k * 1e3),
        plain_samples_per_s='%.0f' % (dec_samples / dec_p * 1e3),
        kernel_ms='%.4f,%.4f' % dec_kr, plain_ms='%.4f,%.4f' % dec_pr,
        stages_kernel_ms='%.4f' % st_k, stages_plain_ms='%.4f' % st_p,
        per_stage_kernel_ms='/'.join('%.4f' % k for k, _ in per_stage),
        per_stage_plain_ms='/'.join('%.4f' % p for _, p in per_stage))
    log('time', card=repr(card), what='tf32_split_v2_32x256',
        split_kernel_device_ms='%.4f' % kernel_split_ms,
        decode_device_ms='%.4f' % dec_device_ms,
        share_of_decode='%.5f' % (kernel_split_ms / dec_k),
        torch_per_weight_ms='%.4f' % torch_split_ms,
        torch_share_of_decode='%.4f' % (torch_split_ms / dec_k))
    log('time', card=repr(card), what='stream_1x4096',
        kernel_samples_per_s='%.0f' % (4096 * UP / stream_ms * 1e3),
        kernel_ms='%.4f' % stream_ms)
    consts = lm._constants(SR, 1024, 1024, 80, 0.0, 8000.0, str(dev))
    f_used, nnz = consts.mel_w.shape[1], int((consts.mel_w != 0).sum())
    enc_bound, enc_bound_by = bound(*logmel_work(*enc_wav.shape, f_used, nnz),
                                    fp64_peak=PEAK_FP64_CUDA_CORES)
    enc_dft_bound, _ = bound(*logmel_dft_work(*enc_wav.shape, f_used))
    log('bound', card=repr(card), decode_stages_ms='%.4f' % st_bound,
        decode_bound_by=st_bound_by, decode_stages_tc_ms='%.4f' % st_tc,
        encode_ms='%.5f' % enc_bound, encode_bound_by=enc_bound_by,
        encode_dft_bound_ms='%.4f' % enc_dft_bound)

    # 7. the training path
    train_logmel, cudnn_step, k4_entry = train_path(dev, card)

    # 8. the K6 training route
    k6_entries = kernel_route(dev, card, cudnn_step)

    # 9. HiFi-GAN v1 serving
    v1_narrow, v1_narrow_err, v1_entries = v1_serving(dev, card, rng)

    # 10. flash attention and the blockwise MultiHeadAttention route
    k5_entries = attention_path(dev, card)

    # 11. the recipe from disk: metas, loaders, main() on K2 / K4 / K6
    recipe_launches = recipe_path(dev, card, kernel_route.step_ms)
    k4_entry['launches'] += int(recipe_launches[1])
    k4_entry['bwd_launches'] += int(recipe_launches[2])
    for entry, n in zip(k6_entries, recipe_launches[3:]):
        entry['launches'] += int(n)

    # 12. the DSP layer and the VoiceBank enhancement recipe
    dsp_logmel, k2_speech, direct_entry, k4_speech = dsp_path(dev, card, rng)
    k4_entry.update(k4_speech)

    # 13. feature extraction: the native runtime, the resampler and
    #     extract_features on K2
    feature_logmel, k2_extract = feature_path(dev, card)

    # 14. the text-to-speech family: the LJSpeech recipe on K2, synthesis,
    #     the v2 decode on K1, Griffin-Lim, short STFTs on cuFFT
    tts_logmel, tts_gen_stage = tts_path(dev, card)

    # 15. separation and transcription: K2 at the Maestro geometry, the
    #     DSD100 and Maestro recipes' main, separate
    sep_logmel, k2_maestro = separation_path(dev, card)

    # 16. the multi-GPU layer on the one card: one NCCL rank bit-identical
    #     to no mesh on the K6 route, two gloo ranks against one process,
    #     ring attention, a recipe's use_mesh path, the dry run
    mgpu = multigpu_path(dev, card)
    k4_entry['launches'] += mgpu[1]
    k4_entry['bwd_launches'] += mgpu[2]
    for entry, n in zip(k6_entries, mgpu[3:]):
        entry['launches'] += n

    # 17. the serving fast modes: K1 in 'bf16x3' / 'default' and K3 in
    #     'default' on the bf16 tensor cores, the interfaces' precision= and
    #     dtype='bfloat16'
    fast_entries = fast_modes_path(dev, card, rng)

    # 18. the critics' fast modes: K6 in 'default' and on bf16 tensors, the
    #     folded MSD, the recipe's steps with msd_folded and disc_bf16
    critic_entries = critic_modes_path(dev, card, cudnn_step)

    # 19. the generator's modes: K6 and the repaired cuDNN route in 'default'
    #     on v2's and v1's generator convs, the recipe in JAX's modes
    #     (generator and critics 'default', K2 / K4 'bf16x3') on both routes
    gen_mode_entries = gen_modes_path(dev, card)

    print(json.dumps({'kernels': [
        {'name': 'gen_stage', 'route': 'cuda', 'source': gs.SOURCE,
         'replaces': 'pytorch_sound_tpu/ops/pallas/gen_stage.py:282',
         'launches': launches['gen_stage'] + v1_narrow + tts_gen_stage,
         'max_abs_err': max(errs['gen_stage'], v1_narrow_err),
         'ms': st_k, 'plain_ms': st_p, 'bound_ms': st_bound, 'bound_by': st_bound_by,
         'tc_bound_ms': st_tc, 'library_ms': None},
        {'name': 'logmel', 'route': 'cuda', 'source': lm.SOURCE,
         'replaces': 'pytorch_sound_tpu/ops/pallas/logmel.py:157',
         'launches': (launches['logmel'] + train_logmel + int(recipe_launches[0]) + dsp_logmel
                      + feature_logmel + tts_logmel + sep_logmel + mgpu[0]),
         'max_abs_err': errs['logmel'],
         'ms': enc_k, 'plain_ms': enc_p, 'bound_ms': enc_bound, 'bound_by': enc_bound_by,
         'dft_bound_ms': enc_dft_bound, 'stft_ms': stft_ms, **k2_extract, **k2_speech,
         **k2_maestro, 'library_ms': None},
        direct_entry,
        k4_entry,
        *k6_entries,
        *v1_entries,
        *k5_entries,
        *fast_entries,
        *critic_entries,
        *gen_mode_entries,
    ]}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    sys.exit(main())
