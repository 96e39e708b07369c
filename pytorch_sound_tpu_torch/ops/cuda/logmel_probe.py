"""Times the log-mel kernels (K2, and K4's forward and backward) of one tree of
the repository on a card, so that two trees (a commit and its parent) are
compared on one machine, in turns.

    python pytorch_sound_tpu_torch/ops/cuda/logmel_probe.py [ROOT] [--profile]
        [--direct] [--set NAME=VALUE]

ROOT (default: the checkout holding this file) is the root of the tree whose
``pytorch_sound_tpu_torch`` is imported and built; the script only calls the
entry points every tree has (``fused_hifigan_mel``,
``fused_hifigan_mel_trainable``, ``ops.mel.hifigan_mel_spectrogram``). Inputs
are seeded harmonic tones at the shapes ``chip_smoke.py`` times: the encode
batch (16 x 2 s) and the training batch (16 x 8192). Each time is the mean of
20 calls after 2 warm-ups (CUDA events), plain, kernel, kernel, plain; K4's
backward is forward + backward minus forward. Prints one JSON line with the
card's name and power limit. ``--profile`` then traces 20 calls of each
of K2 at the encode shape, K2 at the training shape, K4's backward kernels
called alone and K4 forward + backward through autograd with
``torch.profiler`` and prints, per workload, the device time of each kernel
and the host time of the busiest operators per call; and times, as K4's
backward is timed, an autograd function whose forward is K2 and whose
backward only returns zeros: the part of that time autograd itself takes.

``--direct`` also times K2 at 16 x 4 s of tones for each geometry that ran
on the direct DFT until the mixed-radix FFT took it (``chip_smoke.py``'s
``FFT_GEOMETRIES``: 400 / 100 at 16 kHz, 1000 / 250, 128 / 32 at 8 kHz,
8192 / 2048, 300 / 100, 375 / 125) and at 802 / 401, which stays direct,
and K4's backward at 400 / 100, each the mean of 20 calls after 2 warm-ups,
through the entry points; where the tree's wrapper has the private
``_direct_log_mel`` / ``_direct_backward``, the same again on the direct DFT,
in the same process, and a one-frame call (the host's floor under every event
time: a call whose kernel is shorter than its host work measures the host).
With ``--profile`` it also gives each one's device time (the profiler's sum
of its kernels) and traces K2 and K4's backward at 400 / 100. ``--set NAME=VALUE`` runs all of it on a copy of ROOT's
package, kept in ROOT's ignored build directory, whose ``csrc/logmel.cu``
has ``constexpr int NAME = VALUE;`` (``kMaxFrames``, ``kDirectFrames``, ...)
instead of ROOT's value, so that variants are compared in one call, in
turns:

    python logmel_probe.py --direct; python logmel_probe.py --direct --set kMaxFrames=4
"""

import json
import os
import re
import shutil
import subprocess
import sys

# (sample rate, n_fft, hop, mels, fmax): chip_smoke.py's FFT_GEOMETRIES, then
# a geometry that stays on the direct DFT
GEOMETRIES = ((16000, 400, 100, 80, 8000.0), (22050, 1000, 250, 80, 8000.0),
              (8000, 128, 32, 40, None), (22050, 8192, 2048, 80, None),
              (16000, 300, 100, 80, 8000.0), (16000, 375, 125, 80, 8000.0),
              (16000, 802, 401, 80, 8000.0))


def tones(rng, n, samples, sr=22050):
    import numpy as np
    t = np.arange(samples) / sr
    f0 = rng.uniform(110.0, 300.0, size=(n, 1))
    wav = sum(0.4 / h * np.sin(2 * np.pi * h * f0 * t) for h in (1, 2, 3))
    wav = wav + 0.003 * rng.standard_normal((n, samples))
    return (0.6 * wav / np.abs(wav).max(axis=1, keepdims=True)).astype(np.float32)


def cuda_ms(fn, iters=20):
    import torch
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def paired(plain, kernel):
    p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def profile(name, fn, iters=20):
    """Per-call device time of each CUDA kernel and host time of the top
    operators over ``iters`` calls of ``fn``, by ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    dev = {e.key: e.device_time_total / iters / 1e3 for e in events
           if getattr(e, 'device_time_total', 0) > 0 and e.device_type.name == 'CUDA'}
    host = sorted(((e.cpu_time_total / iters / 1e3, e.key) for e in events
                   if e.device_type.name == 'CPU'), reverse=True)[:8]
    print(json.dumps({'profile': name, 'device_ms_per_call': dev,
                      'host_ms_per_call': {k: v for v, k in host}}), flush=True)


def device_ms(fn, per_call=1, iters=20, attempts=3):
    """Device time per call of ``fn``, which launches ``per_call`` kernels a
    call: their time over ``iters`` calls by ``torch.profiler``, summed,
    over ``iters``, from a session that kept every kernel record (run again
    up to ``attempts`` times, as ``chip_smoke.device_ms``); None where none
    did."""
    import torch
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    for _ in range(attempts):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == 'CUDA' and getattr(e, 'device_time_total', 0.0) > 0]
        if sum(e.count for e in kernels) == per_call * iters:
            return sum(e.device_time_total for e in kernels) / iters / 1e3
    return None


def constant_copy(root, name, value):
    """ROOT's package copied under its build directory with
    ``constexpr int NAME = VALUE;`` in ``csrc/logmel.cu``; returns the
    copy's root (reused by a later call with the same setting)."""
    package = os.path.join(root, 'pytorch_sound_tpu_torch')
    out = os.path.join(package, 'csrc', 'build', 'probe_%s_%d' % (name, value))
    if not os.path.isdir(out):
        tmp = '%s.%d' % (out, os.getpid())
        shutil.copytree(package, os.path.join(tmp, 'pytorch_sound_tpu_torch'),
                        ignore=shutil.ignore_patterns('build', '__pycache__'))
        path = os.path.join(tmp, 'pytorch_sound_tpu_torch', 'csrc', 'logmel.cu')
        with open(path) as f:
            src = f.read()
        changed, n = re.subn(r'constexpr int %s = \d+;' % name,
                             'constexpr int %s = %d;' % (name, value), src)
        if n != 1:
            raise SystemExit('logmel_probe: no constant %s in %s' % (name, path))
        with open(path, 'w') as f:
            f.write(changed)
        os.rename(tmp, out)
    return out


def direct_times(lm, dev, rng, trace):
    """ms of K2 per geometry and of K4's backward at 400 / 100, each at
    16 x 4 s of tones, through the entry points and, where the wrapper has
    ``_direct_log_mel``, on the direct DFT; with ``trace`` also each one's device
    time (:func:`device_ms`) and, at 400 / 100, a profile; and the time of
    a one-frame call, the host's floor under every event time."""
    import torch
    routes = {'auto': (lm.fused_log_mel, lm.hifigan_mel_backward)}
    if hasattr(lm, '_direct_log_mel'):
        routes['direct'] = (lm._direct_log_mel, lm._direct_backward)
    out = {}
    for route, (forward, backward) in routes.items():
        k2, k2_dev = {}, {}
        for sr, n_fft, hop, n_mels, fmax in GEOMETRIES:
            x = torch.from_numpy(tones(rng, 16, 4 * sr, sr)).to(dev)

            def call():
                return forward(x, sr, n_mels, n_fft, n_fft, hop, -50, 30, 0, fmax)

            with torch.inference_mode():
                k2['%d_%d' % (n_fft, hop)] = cuda_ms(call)
                if trace:
                    k2_dev['%d_%d' % (n_fft, hop)] = device_ms(call)
        x = torch.from_numpy(tones(rng, 16, 4 * 16000, 16000)).to(dev)
        geom = dict(sampling_rate=16000, n_fft=400, window_size=400, hop_size=100, num_mels=80,
                    fmax=8000.0)
        cot = torch.cos(lm.fused_log_mel(x, 16000, 80, 400, 400, 100, mel_max=8000.0, pad=150,
                                         power_eps=1e-9, log_floor=1e-5))
        one = x[:1, :400].contiguous()
        with torch.inference_mode():
            k4 = cuda_ms(lambda: backward(x, cot, **geom))
            floor = cuda_ms(lambda: forward(one, 16000, 80, 400, 400, 100, -50, 30, 0,
                                            8000.0, pad=0))
            if trace:
                k2_dev['k4_bwd_400_100'] = device_ms(lambda: backward(x, cot, **geom), 2)
                profile('k2_16x4s_400_100_%s' % route,
                        lambda: forward(x, 16000, 80, 400, 400, 100, -50, 30, 0, 8000.0))
                profile('k4_bwd_16x4s_400_100_%s' % route, lambda: backward(x, cot, **geom))
        out[route] = {'k2_16x4s_ms': k2, 'k4_bwd_16x4s_400_100_ms': k4,
                      'one_frame_call_ms': floor, 'device_ms': k2_dev}
    return out


def main():
    argv = sys.argv[1:]
    setting = None
    if '--set' in argv:
        i = argv.index('--set')
        name, value = argv[i + 1].split('=')
        setting = (name, int(value))
        del argv[i:i + 2]
    args = [a for a in argv if a not in ('--profile', '--direct')]
    root = os.path.abspath(args[0] if args else
                           os.path.join(os.path.dirname(os.path.abspath(__file__)), '..', '..', '..'))
    if setting is not None:
        root = constant_copy(root, *setting)
    sys.path.insert(0, root)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('logmel_probe: no CUDA device is available')
    from pytorch_sound_tpu_torch.ops import mel as mel_ops
    from pytorch_sound_tpu_torch.ops.cuda import _build
    from pytorch_sound_tpu_torch.ops.cuda import logmel as lm
    assert os.path.dirname(os.path.abspath(lm.__file__)).startswith(root), lm.__file__
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    _build.library()
    rng = np.random.default_rng(0)
    enc = torch.from_numpy(tones(rng, 16, 2 * 22050)).to(dev)
    train = torch.from_numpy(tones(rng, 16, 8192)).to(dev)

    def fwd_bwd(fn):
        w = train.clone().requires_grad_(True)
        fn(w).sum().backward()

    with torch.inference_mode():
        enc_k, enc_p = paired(lambda: mel_ops.hifigan_mel_spectrogram(enc),
                              lambda: lm.fused_hifigan_mel(enc))
    fwd_k, fwd_p = paired(lambda: mel_ops.hifigan_mel_spectrogram(train),
                          lambda: lm.fused_hifigan_mel_trainable(train))
    fb_k, fb_p = paired(lambda: fwd_bwd(mel_ops.hifigan_mel_spectrogram),
                        lambda: fwd_bwd(lm.fused_hifigan_mel_trainable))
    print(json.dumps({'root': root, 'card': card, 'k2_encode_16x2s_ms': enc_k,
                      'plain_encode_16x2s_ms': enc_p, 'k4_fwd_16x8192_ms': fwd_k,
                      'plain_fwd_16x8192_ms': fwd_p, 'k4_bwd_16x8192_ms': fb_k - fwd_k,
                      'plain_bwd_16x8192_ms': fb_p - fwd_p}), flush=True)
    if '--direct' in argv:
        print(json.dumps({'root': root, 'card': card,
                          'setting': '%s=%d' % setting if setting else None,
                          **direct_times(lm, dev, rng, '--profile' in argv)}), flush=True)
    if '--profile' in sys.argv:
        cot = torch.cos(lm.fused_hifigan_mel(train))
        with torch.inference_mode():
            profile('k2_encode_16x2s', lambda: lm.fused_hifigan_mel(enc))
            profile('k2_train_16x8192', lambda: lm.fused_hifigan_mel(train))
            if hasattr(lm, 'hifigan_mel_backward'):
                profile('k4_bwd_kernels_16x8192', lambda: lm.hifigan_mel_backward(train, cot))
        profile('k4_fwd_bwd_16x8192', lambda: fwd_bwd(lm.fused_hifigan_mel_trainable))

        class ZeroBackward(torch.autograd.Function):
            @staticmethod
            def forward(ctx, w):
                return lm.fused_hifigan_mel(w)

            @staticmethod
            def backward(ctx, g):
                return torch.zeros((16, 8192), device=g.device)

        fwd_z = cuda_ms(lambda: ZeroBackward.apply(train))
        fb_z = cuda_ms(lambda: fwd_bwd(ZeroBackward.apply))
        fwd_k, fb_k = cuda_ms(lambda: lm.fused_hifigan_mel_trainable(train)), \
            cuda_ms(lambda: fwd_bwd(lm.fused_hifigan_mel_trainable))
        print(json.dumps({'card': card, 'zero_backward_bwd_16x8192_ms': fb_z - fwd_z,
                          'k4_bwd_16x8192_ms': fb_k - fwd_k}), flush=True)


if __name__ == '__main__':
    main()
