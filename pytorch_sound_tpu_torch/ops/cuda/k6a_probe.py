"""Variants of the grouped-conv tap kernel (``conv_tap_kernel``, K6a's forward
and dx in ``csrc/grouped_conv.cu``) timed on a card over the 58 convs whose
forward and dx ``chip_smoke.py`` phase 8.1 runs: MPD base's and MSD base's
convs at the critic phase's 32 x 8192 batch, v2's four upsamples as their
mirror convs at 16 x 8192. Inputs are seeded normals at those shapes.

    python -m pytorch_sound_tpu_torch.ops.cuda.k6a_probe build [VARIANT ...]
    python -m pytorch_sound_tpu_torch.ops.cuda.k6a_probe run VARIANT

``build`` compiles each variant (the source with the lines of ``VARIANTS``
replaced; all of them by default) into ``csrc/build/k6a_probe/<variant>/``
and prints the tap kernel's registers and spills (``-Xptxas -v``); ``run``
times the forward and dx of every layer with one variant (one process each,
CUDA events, mean of 5 calls after 2 warm-ups) and prints one JSON line:
the card, the sums over the layers, and per layer ms and the error against
the plain version. Compare variants only within one machine.
"""

import ctypes
import json
import os
import re
import subprocess
import sys

from pytorch_sound_tpu_torch.ops.cuda import _build

_MMA = 'for (int i = 0; i < MI; ++i) mma_3xtf32(part[i * NJ + j], ah[i], al[i], bh, bl);'
_KLOOP = '      for (int kk = 0; kk < BK; kk += 8) {\n        const int o0'
_WINDOW = 'for (int e = tid; e < ent; e += NTH) {\n      const int u = tab_u[e];'
_A_COPY = '        cp_async16(As + row * LDA + q, ok ?'
_TILE128 = 'if (rows >= 128) PSTT_TAP(128, 64, 2, 2)'

# name -> [(text, replacement)]: each text occurs once from the tap kernel on
# ('conv_tap_kernel(') or, if not there, once in the whole source
VARIANTS = {
    'base': [],
    # one TF32 product per pair instead of three (wrong results: timing only)
    'one_product': [(_MMA, 'for (int i = 0; i < MI; ++i) mma_tf32(part[i * NJ + j], ah[i], bh);')],
    # no compute loop: staging, barriers and epilogue only
    'no_compute': [(_KLOOP, _KLOOP.replace('kk < BK;', 'kk < BK && K < 0;'))],
    # no staging of A or the window: the compute loop on whatever shared memory holds
    'no_staging': [(_WINDOW, _WINDOW.replace('e < ent;', 'e < ent && K < 0;')),
                   (_A_COPY, '        if (K < 0) cp_async16(As + row * LDA + q, ok ?')],
    'two_stages': [('constexpr int kTapStages = 3;', 'constexpr int kTapStages = 2;')],
    'stage64': [('constexpr int kTapBK = 32;', 'constexpr int kTapBK = 64;')],
    'tile128x128': [(_TILE128, 'if (rows >= 128) PSTT_TAP(128, 128, 2, 4)')],
    # a fresh accumulator per 8-deep k-step (mma_3xtf32_add), no per-stage one
    'kstep_acc': [(_MMA, 'for (int i = 0; i < MI; ++i) mma_3xtf32_add(acc[i * NJ + j], '
                         'ah[i], al[i], bh, bl);'),
                  ('    add_part(acc, part);\n  }\n', '  }\n')],
    # the tap kernel also below one stage of reduction (the critics' first
    # layers, conv_post's dx)
    'no_depth_rule': [('if (p.depth < kTapBK || p.smem', 'if (p.smem')],
}


def phase8_geometries(batch=32, seg=8192, gen_batch=16):
    """(name, n, cin, t_in, cout, k, stride, padding, dilation, groups) of
    every conv ``chip_smoke.py`` phase 8.1 runs the forward and dx of: MPD
    base's and MSD base's convs at the critic phase's batch x seg (the
    period folded into the batch, the scales average-pooled), and v2's four
    upsamples as their mirror convs (cout = the upsample's input channels)
    at gen_batch items of seg samples."""
    from pytorch_sound_tpu_torch.ops.cuda.grouped_conv import conv_out_len
    out = []
    for period in (2, 3, 5, 7, 11):
        n, t, cin = batch * period, -(-seg // period), 1
        for i, ch in enumerate((32, 128, 512, 1024)):
            out.append(('mpd.period_%d.conv_%d' % (period, i), n, cin, t, ch, 5, 3, 2, 1, 1))
            t, cin = conv_out_len(t, 5, 3, 2), ch
        out.append(('mpd.period_%d.conv_4' % period, n, 1024, t, 1024, 5, 1, 2, 1, 1))
        out.append(('mpd.period_%d.conv_post' % period, n, 1024, t, 1, 3, 1, 1, 1, 1))
    t = seg
    layout = [(1, 128, 15, 1, 1, 7), (128, 128, 41, 2, 4, 20), (128, 256, 41, 2, 8, 20),
              (256, 512, 41, 4, 8, 20), (512, 1024, 41, 4, 8, 20), (1024, 1024, 41, 1, 8, 20),
              (1024, 1024, 5, 1, 1, 2), (1024, 1, 3, 1, 1, 1)]
    for scale in range(3):
        if scale:
            t = t // 2 + 1                      # avg_pool1d(4, 2, padding 2)
        tt = t
        for i, (ic, oc, k, s, g, p) in enumerate(layout):
            name = 'msd.scale_%d.%s' % (scale, 'conv_post' if i == 7 else 'conv_%d' % i)
            out.append((name, batch, ic, tt, oc, k, s, p, 1, g))
            tt = conv_out_len(tt, k, s, p)
    t, ch = seg // 256, 128
    for i, (u, k) in enumerate(zip((8, 8, 2, 2), (16, 16, 4, 4))):
        t_up = (t - 1) * u + k - 2 * ((k - u) // 2)
        out.append(('gen.ups_%d' % i, gen_batch, ch // 2, t_up, ch, k, u, (k - u) // 2, 1, 1))
        t, ch = t_up, ch // 2
    return out


def variant_source(name: str) -> str:
    """grouped_conv.cu with the variant's replacements."""
    src = open(os.path.join(_build.CSRC, 'grouped_conv.cu')).read()
    for old, new in VARIANTS[name]:
        start = src.index('conv_tap_kernel(')
        head, tail = src[:start], src[start:]
        if tail.count(old) == 1:
            src = head + tail.replace(old, new)
        elif src.count(old) == 1:
            src = src.replace(old, new)
        else:
            raise ValueError('variant %s: %r found %d times' % (name, old, src.count(old)))
    return src


def _variant_dir(name: str) -> str:
    return os.path.join(_build.BUILD_DIR, 'k6a_probe', name)


def build(names):
    """Compile the variants in parallel; print each tap kernel's registers
    and spills."""
    procs = []
    for name in names:
        d = _variant_dir(name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, 'grouped_conv.cu'), 'w') as f:
            f.write(variant_source(name))
        for header in ('tf32_mma.cuh', 'bf16_mma.cuh'):
            with open(os.path.join(_build.CSRC, header)) as f, \
                    open(os.path.join(d, header), 'w') as g:
                g.write(f.read())
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, '-shared', '-Xptxas', '-v', '-o',
               os.path.join(d, 'lib.so'), os.path.join(d, 'grouped_conv.cu')]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True)))
    for name, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError('variant %s failed to build:\n%s' % (name, err))
        lines = err.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r'conv_tap_kernelILi(\d)ELi(\d+)ELi(\d+)', line)
            if m and 'Compiling' in line:
                info = ' '.join(lines[i + 1:i + 4])
                regs = re.search(r'Used (\d+) registers', info)
                spill = re.search(r'(\d+) bytes spill stores', info)
                print('%s %s %sx%s registers=%s spill_stores=%s' % (
                    name, 'fwd' if m.group(1) == '0' else 'dx', m.group(2), m.group(3),
                    regs and regs.group(1), spill and spill.group(1)), flush=True)


def run(name: str):
    """Time the forward and dx of every phase-8 layer with the variant."""
    import numpy as np
    import torch
    from pytorch_sound_tpu_torch.ops.cuda import grouped_conv as gc
    if not torch.cuda.is_available():
        raise RuntimeError('k6a_probe times kernels on a CUDA card')
    torch.backends.cudnn.allow_tf32 = False
    lib = ctypes.CDLL(os.path.join(_variant_dir(name), 'lib.so'))
    for fn in ('grouped_conv_forward', 'grouped_conv_input_grad'):
        getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    _build.library = lambda: lib
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    def ms(fn):
        for _ in range(2):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 5

    sums, layers = {'fwd': 0.0, 'dx': 0.0}, {}
    for lname, n, cin, t_in, cout, k, s, p, d, g in phase8_geometries():
        conf = dict(stride=s, padding=p, dilation=d, groups=g)
        t_out = gc.conv_out_len(t_in, k, s, p, d)
        x, gy = arr(n, cin, t_in), arr(n, cout, t_out)
        w, b = arr(cout, cin // g, k, scale=(cin // g * k) ** -0.5), arr(cout)
        calls = {'fwd': (lambda: gc.conv1d_forward(x, w, b, slope=0.1, **conf),
                         lambda: gc.grouped_conv1d_reference(x, w, b, slope=0.1, **conf)),
                 'dx': (lambda: gc.conv1d_input_grad(gy, w, t_in, **conf),
                        lambda: gc.conv1d_input_grad_reference(gy, w, t_in, **conf))}
        for entry, (kernel, plain) in calls.items():
            got, ref = kernel(), plain()
            err = float((got - ref).abs().max() / ref.abs().max())
            t = ms(kernel)
            sums[entry] += t
            layers['%s.%s' % (lname, entry)] = [round(t, 4), float('%.3g' % err)]
        del x, gy, w, b
    print(json.dumps({'variant': name, 'card': torch.cuda.get_device_name(0),
                      'sum_ms': sums, 'layers': layers}), flush=True)


if __name__ == '__main__':
    if len(sys.argv) < 2 or sys.argv[1] not in ('build', 'run'):
        sys.exit(__doc__)
    if sys.argv[1] == 'build':
        build(sys.argv[2:] or list(VARIANTS))
    else:
        run(sys.argv[2])
