#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's HiFi-GAN serving and training paths, and the
training recipe from wav files on disk, the DSP layer with the VoiceBank
enhancement recipe, and feature extraction from a wav tree, once on one GPU.

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
   on its direct DFT path (n_fft 400 / 100 at 16 kHz, 1000 / 250, 128 / 32,
   8192 / 2048; both conventions against the plain version in fp64, reruns
   bit-identical) and K4's backward there; the transforms' main path
   (``LogMelSpectrogram`` on (N, T) and (N, 1, T), ``MFCC``, and
   ``LogMelSpectrogram`` at 16 kHz, 400 / 100) with exact launch counts;
   timings at 16 x 4 s; then a VoiceBank tree under ``$TMPDIR`` (56 pairs,
   int16), its metas, the loader alone, ``examples.voice_bank.main`` with
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
   staging / H2D / program / D2H / save times, the card's busy share.

The line before the last is a JSON object with one entry per kernel, each
with its time, its plain version's, the least time the card could take for
the same work (``bound_ms``, from the shapes, at the H100's published peaks;
for K2's direct path, ``logmel_direct``, and K4's backward there an FFT's
operations as for the FFT path, the direct DFT's beside them as
``dft_bound_ms`` and ``direct_bwd_dft_bound_ms``;
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


def build_gan(device, seed, kernel=False):
    """HiFi-GAN v2 with weight norm, MPD base and MSD base, initialised from
    ``seed`` with the JAX init, on ``device``. ``kernel=True`` builds the K6
    route: every critic conv (``build_critics(msd_kernel=8, mpd_kernel=True)``)
    and the generator's upsamples (``ups_backend='cuda'``) on the grouped-conv
    kernels; the parameters are the same as the cuDNN route's."""
    import torch
    from pytorch_sound_tpu_torch.examples.hifi_gan import build_critics
    from pytorch_sound_tpu_torch.models import build_model
    from pytorch_sound_tpu_torch.models.vocoders.hifi_gan import init_params
    gen = torch.Generator().manual_seed(seed)
    route = 'cuda' if kernel else 'cudnn'
    models = [build_model('hifi_gan_v2', extra_kwargs={'ups_backend': route}),
              *build_critics(msd_kernel=8 if kernel else -1, mpd_kernel=kernel)]
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


def split_step_pair(specs):
    """One split step for each ``(device, kernel_route)`` of ``specs`` from the
    same parameters and a 2 x 8192 batch, held against the first. Both
    generator phases start from the first trainer's updated critics: Adam's
    first update moves every entry by about +-lr whatever its gradient's size,
    so entries with near-zero gradients may step apart between two correct
    runs. Returns (worst loss rel diff, (worst grad rel diff, its name), the
    losses, the parameter count)."""
    trainers = []
    for device, kernel in specs:
        t = make_trainer(build_gan(device, 1, kernel), device,
                         tempfile.mkdtemp(prefix='chip_smoke_step_'),
                         max_step=1, valid_max_step=1, save_interval=1, log_interval=1)
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
    return loss_rel, (grad_rel[worst], worst), shown, len(grad_rel)


def time_train_steps(trainer, real, n_timed):
    """Two warm-up steps, then ``n_timed`` split steps: (steps/s by the host
    clock ending in a synchronize, per-step ms, disc / gen phase ms by CUDA
    events, peak GB)."""
    import torch
    dev = real.device
    for _ in range(2):
        trainer._train_step([real[:, 0]], is_logging=False)
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


def expected_gc_launches(gen, mpd, msd, steps, valid_batches):
    """Launches of the grouped-conv entry points (forward, dx, dw) in
    ``steps`` split steps and ``valid_batches`` validation batches, from the
    models' routes. Per critic stack with k layers on the kernels: the critic
    phase runs the forward over real + fake, dw of every layer and dx of every
    layer but the first (the waveform carries no gradient); the generator
    phase runs the forward over real (no gradient) and over the fake, and dx
    of every layer (the fake carries the generator's gradient) but no dw (the
    critics are frozen). Each upsample on the kernels runs dx (its forward)
    in both phases' generator passes and each validation batch, and in its
    backward the forward kernel (dx) and dw."""
    fwd = dx = dw = 0
    for disc in (mpd, msd):
        for sub in disc.children():
            convs = [getattr(sub, 'conv_%d' % i) for i in range(sub.n_layers)] + [sub.conv_post]
            on = [c.backend == 'cuda' for c in convs]
            fwd, dw, dx = fwd + 3 * sum(on), dw + sum(on), dx + 2 * sum(on) - on[0]
    ups = sum(getattr(gen, 'ups_%d' % i).backend == 'cuda'
              for i in range(len(gen.upsample_rates)))
    return (steps * (fwd + ups), steps * (dx + 2 * ups) + valid_batches * ups,
            steps * (dw + ups))


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
    gs.generator_stage.launches = gs.generator_stage.wide_launches = 0
    gs.resblock_stage.launches = 0
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
    launches = {'gen_stage': gs.generator_stage.launches,
                'gen_stage_wide': gs.generator_stage.wide_launches,
                'resblock_stage': gs.resblock_stage.launches,
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


# the direct path's geometries: (sample rate, n_fft, hop, mels, fmax)
DIRECT_GEOMETRIES = ((16000, 400, 100, 80, 8000.0), (22050, 1000, 250, 80, 8000.0),
                     (8000, 128, 32, 40, None), (22050, 8192, 2048, 80, None))
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


def dsp_path(dev, card, rng):
    """Phase 12: K2 on its direct path (and K4's backward there), the
    transforms' main path on K2, the VoiceBank recipe from disk, and
    enhance. Returns the main path's K2 launches on the FFT path (those on
    the direct path are the ``logmel_direct`` entry's), the JSON entry of
    K2's direct path and the direct backward's keys for K4's entry."""
    import copy
    import random
    import torch
    from pytorch_sound_tpu_torch.data.meta.voice_bank import VoiceBankMeta, get_datasets
    from pytorch_sound_tpu_torch.examples import voice_bank as vb
    from pytorch_sound_tpu_torch.models import build_model, transforms as T
    from pytorch_sound_tpu_torch.ops import mel as mel_ops, pqmf as pqmf_ops
    from pytorch_sound_tpu_torch.ops import sound as sound_ops
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    from pytorch_sound_tpu_torch.trainer import adam
    from pytorch_sound_tpu_torch.utils.commons import LOGGER
    from pytorch_sound_tpu_torch.utils.wavio import write_wav

    # 12a. K2 at n_fft off the FFT path (the direct DFT): both conventions,
    #      noise and tones, against the plain version in fp64, one launch
    #      each, reruns bit-identical
    worst = 0.0
    for sr, n_fft, hop, n_mels, fmax in DIRECT_GEOMETRIES:
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
                worst = max(worst, err)
                log('direct', n_fft=n_fft, hop=hop, sr=sr, convention=conv, signal=kind,
                    shape=tuple(ker.shape), launches='%d/%d' % launched,
                    vs_fp64='%.3g' % err, rerun_bit_identical=rerun)
                assert ker.shape == ref64.shape and launched == (1, 1), (n_fft, launched)
                assert err <= MEL_TOL and rerun, (n_fft, conv, kind, err, rerun)

    #     K4's backward on the direct path (16 kHz, 400 / 100) against
    #     autograd of the plain version in fp64 on noise and tones, and of
    #     the fp32 plain version on noise, each relative to its largest
    #     entry (on tones the fp32 plain version is itself ~1e-3 off fp64
    #     there: the gradient reaches ~1e3 through 1 / mel in quiet bands)
    k4_geom = dict(sampling_rate=16000, n_fft=400, window_size=400, hop_size=100, num_mels=80,
                   fmax=8000.0)

    def k4_mel(x):
        return lm.fused_log_mel(x, 16000, 80, 400, 400, 100, mel_max=8000.0, pad=150,
                                power_eps=1e-9, log_floor=1e-5)

    bwd_err = bwd_rel = 0.0
    for kind, wav in (('noise', rng.standard_normal((4, 3 * 16000)) * 0.2),
                      ('tones', tones(rng, 4, 3 * 16000, am=False))):
        x = torch.from_numpy(wav.astype(np.float32)).to(dev)
        cot = torch.cos(k4_mel(x))
        before = lm.fused_hifigan_mel_trainable.bwd_launches
        got = lm.hifigan_mel_backward(x, cot, **k4_geom)
        launched = lm.fused_hifigan_mel_trainable.bwd_launches - before
        rerun = torch.equal(got, lm.hifigan_mel_backward(x, cot, **k4_geom))
        ref = lm.hifigan_mel_vjp(x, cot, **k4_geom)
        ref64 = lm.hifigan_mel_vjp(x.double(), cot.double(), **k4_geom)
        torch.cuda.synchronize()
        err = max_err(got, ref) / float(ref.abs().max())
        rel64 = max_err(got.double(), ref64) / float(ref64.abs().max())
        bwd_rel = max(bwd_rel, rel64)
        if kind == 'noise':
            bwd_err = err
        log('k4_bwd', geometry='16k_400_100', signal=kind, launches=launched,
            vs_plain_rel='%.3g' % err, vs_fp64_rel='%.3g' % rel64,
            grad_max='%.3g' % float(ref.abs().max()), rerun_bit_identical=rerun)
        assert launched == 1 and rerun and rel64 <= GRAD_TOL, (kind, launched, rerun, rel64)
        assert kind == 'tones' or err <= GRAD_TOL, (kind, err)

    #     the main path: LogMelSpectrogram at the settings' geometry (the FFT
    #     path) on (N, T) and (N, 1, T), MFCC on (N, 1, T), and
    #     LogMelSpectrogram at 16 kHz, 400 / 100 (the direct path) on
    #     (N, 1, T); counters from zero
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
    assert main_launches == (4, 1), main_launches
    assert mel3.shape == (ENH_BATCH, 1, 80, ENH_SEG // 256 + 1) and torch.equal(mel3[:, 0], mel2)
    assert mfcc.shape == (ENH_BATCH, 1, 40, ENH_SEG // 256 + 1) and mfcc_err <= 1e-5
    assert mel16.shape == (16, 1, 80, 641) and max(err2, err16) <= MEL_TOL, (err2, err16)
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
    #     geometry) and K4's backward (the HiFi-GAN convention) against their
    #     plain versions
    c = lm._constants(16000, 400, 400, 80, 0.0, 8000.0, str(dev))
    f_used, nnz = c.mel_w.shape[1], int((c.mel_w != 0).sum())
    x16 = wav16
    with torch.inference_mode():
        k_ms, p_ms, k_runs, p_runs = paired_ms(
            lambda: mel_ops.log_mel_spectrogram(x16, *speech16),
            lambda: lm.fused_log_mel(x16, 16000, 80, 400, 400, 100, -50, 30, 0, 8000), 20)
    frames = 1 + x16.shape[1] // 100
    k_bound, k_bound_by = bound(2.0 * nnz * 16 * frames, fft_flops(400, f_used) * 16 * frames,
                                4.0 * (x16.numel() + 16 * 80 * frames),
                                fp64_peak=PEAK_FP64_CUDA_CORES)
    dft_bound, _ = bound(*direct_work(16, x16.shape[1], frames, 400, f_used, nnz, 80),
                         fp64_peak=PEAK_FP64_CUDA_CORES)
    cot16 = torch.cos(k4_mel(x16))
    b_ms, bp_ms, b_runs, bp_runs = paired_ms(
        lambda: lm.hifigan_mel_vjp(x16, cot16, **k4_geom),
        lambda: lm.hifigan_mel_backward(x16, cot16, **k4_geom), 10)
    bframes = cot16.shape[-1]
    assert bframes == logmel_frames(x16.shape[1], 400, 100), bframes
    b_bound, b_bound_by = bound(*logmel_bwd_work(16, x16.shape[1], f_used, nnz, 80, 400, 100),
                                fp64_peak=PEAK_FP64_CUDA_CORES)
    b_dft_bound, _ = bound(*direct_bwd_work(16, x16.shape[1], bframes, 400, 100, f_used,
                                            nnz, 80), fp64_peak=PEAK_FP64_CUDA_CORES)
    log('time', card=repr(card), what='k2_direct_16x4s_16k_400_100', kernel_ms='%.4f' % k_ms,
        plain_ms='%.4f' % p_ms, kernel_runs='%.4f,%.4f' % k_runs,
        plain_runs='%.4f,%.4f' % p_runs, bound_ms='%.5f' % k_bound, bound_by=k_bound_by,
        dft_bound_ms='%.5f' % dft_bound, bwd_kernels_ms='%.4f' % b_ms,
        plain_vjp_ms='%.4f' % bp_ms, bwd_runs='%.4f,%.4f' % b_runs,
        plain_vjp_runs='%.4f,%.4f' % bp_runs, bwd_bound_ms='%.5f' % b_bound,
        bwd_bound_by=b_bound_by, bwd_dft_bound_ms='%.5f' % b_dft_bound)
    entry = {'name': 'logmel_direct', 'route': 'cuda', 'source': lm.SOURCE,
             'replaces': 'pytorch_sound_tpu/ops/pallas/logmel.py:157',
             'launches': main_launches[1], 'max_abs_err': worst, 'ms': k_ms, 'plain_ms': p_ms,
             'bound_ms': k_bound, 'bound_by': k_bound_by, 'dft_bound_ms': dft_bound,
             'shape': '16x64000_16k_400_100', 'library_ms': None}
    k4_direct = {'direct_bwd_ms': b_ms, 'direct_plain_vjp_ms': bp_ms,
                 'direct_bwd_bound_ms': b_bound, 'direct_bwd_bound_by': b_bound_by,
                 'direct_bwd_dft_bound_ms': b_dft_bound,
                 'direct_bwd_rel_err': bwd_err, 'direct_bwd_fp64_rel_err': bwd_rel}

    # 12b. the recipe from disk: a VoiceBank tree (tones plus white noise, as
    #      tests/test_e2e_voicebank.py:27-48), its metas, the loader alone,
    #      main() with spec_masker_base at 8 x 32768 for 6 steps, and 3 steps
    #      plus a resume to 6 whose step-6 checkpoint equals the first run's
    deterministic = torch.backends.cudnn.deterministic
    work = tempfile.mkdtemp(prefix='chip_smoke_vb_')
    try:
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
        meta_s = time.perf_counter() - t0
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
    return main_launches[0] - main_launches[1], entry, k4_direct


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
    gs.generator_stage.launches = 0
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

    launches = {'gen_stage': gs.generator_stage.launches,
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
    dsp_logmel, direct_entry, k4_direct = dsp_path(dev, card, rng)
    k4_entry.update(k4_direct)

    # 13. feature extraction: the native runtime, the resampler and
    #     extract_features on K2
    feature_logmel, k2_extract = feature_path(dev, card)

    print(json.dumps({'kernels': [
        {'name': 'gen_stage', 'route': 'cuda', 'source': gs.SOURCE,
         'replaces': 'pytorch_sound_tpu/ops/pallas/gen_stage.py:282',
         'launches': launches['gen_stage'] + v1_narrow,
         'max_abs_err': max(errs['gen_stage'], v1_narrow_err),
         'ms': st_k, 'plain_ms': st_p, 'bound_ms': st_bound, 'bound_by': st_bound_by,
         'tc_bound_ms': st_tc, 'library_ms': None},
        {'name': 'logmel', 'route': 'cuda', 'source': lm.SOURCE,
         'replaces': 'pytorch_sound_tpu/ops/pallas/logmel.py:157',
         'launches': (launches['logmel'] + train_logmel + int(recipe_launches[0]) + dsp_logmel
                      + feature_logmel),
         'max_abs_err': errs['logmel'],
         'ms': enc_k, 'plain_ms': enc_p, 'bound_ms': enc_bound, 'bound_by': enc_bound_by,
         'dft_bound_ms': enc_dft_bound, 'stft_ms': stft_ms, **k2_extract, 'library_ms': None},
        direct_entry,
        k4_entry,
        *k6_entries,
        *v1_entries,
        *k5_entries,
    ]}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': name,
                                             'count': torch.cuda.device_count()}}),
          flush=True)


if __name__ == '__main__':
    sys.exit(main())
