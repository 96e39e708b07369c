"""The plan of the log-mel FFT kernels (``csrc/logmel.cu``) on the CPU.

The card's kernels cannot run here, so a numpy fp64 twin of their plan, read
from the source, stands in: the packing of an even frame into an n_fft /
2-point complex sequence (an odd frame is its own n_fft-point one), the
mixed-radix Stockham passes (8, 4, 2, 3, 5, 7) and their twiddle indices,
the split into the one-sided spectrum, the band-limited mel and, for K4's
backward, the adjoint of the trimmed DFT by one inverse FFT, the overlap-add
and the reflect pad's adjoint; beside it the threads' share of each pass and
the shared-memory banks they hit. The twin is held against ``torch.fft.rfft``
(1e-12 of the frame's norm), against the JAX package's Pallas kernels in
interpret mode (1e-4, tests/test_pallas.py:98 and :305) and, for the
backward, against fp64 autograd of the port's plain composite (1e-10).
"""

import os
import re

import jax

jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from pytorch_sound_tpu.ops.pallas.logmel import fused_hifigan_mel as jax_fused_hifigan_mel  # noqa: E402
from pytorch_sound_tpu.ops.pallas.logmel import fused_hifigan_mel_trainable as jax_trainable  # noqa: E402
from pytorch_sound_tpu.ops.pallas.logmel import fused_log_mel as jax_fused_log_mel  # noqa: E402
from pytorch_sound_tpu_torch.ops import mel as mel_ops  # noqa: E402
from pytorch_sound_tpu_torch.ops.cuda import logmel as lm  # noqa: E402

SRC = open(os.path.join(os.path.dirname(__file__), '..', lm.SOURCE)).read()
TOL = 1e-4            # values and gradients against the JAX kernels
SR = 22050


# ---------------------------------------------------------------- the twin

def plan_body():
    body = SRC[SRC.index('__host__ __device__ constexpr FftPlan make_plan(int n_fft) {'):]
    return body[:body.index('\n}\n')]


def radices(p):
    """The passes of ``make_plan`` in the source for a P-point FFT: its
    statements (radix 8 while 8 divides what is left, one radix 4, one
    radix 2, then 3, 5 and 7 while they divide) run in their order; None
    where a prime factor above 7 is left."""
    body = plan_body()
    steps = re.findall(r'(while|if) \(rest % (\d) == 0\) \{ radices \|= (\d)ull << \(4 \* n\+\+\); '
                       r'rest /= (\d); \}', body)
    assert [(kind, int(a)) for kind, a, b, c in steps] == [('while', 8), ('if', 4), ('if', 2)]
    assert all(a == b == c for _, a, b, c in steps)
    lo, hi = re.search(r'for \(int r = (\d); r <= (\d); r \+= 2\)\n\s+while \(rest % r == 0\) '
                       r'\{ radices \|= static_cast<unsigned long long>\(r\) << \(4 \* n\+\+\); '
                       r'rest /= r; \}', body).groups()
    odd = list(range(int(lo), int(hi) + 1, 2))
    assert odd == [3, 5, 7]
    out, rest = [], p
    for kind, r, _, _ in steps:
        r = int(r)
        while rest % r == 0:
            out.append(r)
            rest //= r
            if kind == 'if':
                break
    for r in odd:
        while rest % r == 0:
            out.append(r)
            rest //= r
    return out if rest == 1 else None


def threads(p):
    """Threads a frame (TF): ceil(P / kPointsPerThread), from 8 on a
    multiple of 8."""
    body = plan_body()
    assert 'int tf = (p + kPointsPerThread - 1) / kPointsPerThread;' in body
    assert 'if (tf >= 8) tf = (tf + 7) / 8 * 8;' in body
    per = kernel_constant('kPointsPerThread')
    tf = (p + per - 1) // per
    return (tf + 7) // 8 * 8 if tf >= 8 else tf


def padded(p):
    """Whether a P-point frame's rows of 8 are padded (8 | P)."""
    assert 'return FftPlan{p, tf, n, odd, p % 8 == 0, radices};' in plan_body()
    return p % 8 == 0


def sidx(i, pad):
    assert 'int sidx(int i, bool pad) { return pad ? i + (i >> 3) : i; }' in SRC
    return i + (i >> 3) if pad else i


def kernel_constant(name):
    return int(re.search(r'constexpr int %s = (\d+);' % name, SRC).group(1))


def dft_radix(v, tw):
    """The kernel's dft2 / dft4 / dft8 / dft_odd on the leading axis of v,
    their constants from the P-point table tw as the kernel reads them."""
    def dft4(u0, u1, u2, u3):
        s0, d0, s1, d1 = u0 + u2, u0 - u2, u1 + u3, (u1 - u3) * -1j
        return s0 + s1, d0 + d1, s0 - s1, d0 - d1
    radix, nb = len(v), len(tw) // len(v)
    if radix == 2:
        return np.stack([v[0] + v[1], v[0] - v[1]])
    if radix == 4:
        return np.stack(dft4(*v))
    if radix == 8:
        c8 = tw[nb].real
        a = [v[r] + v[r + 4] for r in range(4)]
        b = [v[r] - v[r + 4] for r in range(4)]
        b[1] = (b[1].real + b[1].imag) * c8 + 1j * (b[1].imag - b[1].real) * c8
        b[2] = b[2] * -1j
        b[3] = (b[3].imag - b[3].real) * c8 - 1j * (b[3].real + b[3].imag) * c8
        a, b = dft4(*a), dft4(*b)
        return np.stack([x for pair in zip(a, b) for x in pair])
    h = (radix - 1) // 2               # dft_odd: cos / sin (2 pi m / R) = W_P^(m P / R)
    c = {m: tw[m * nb].real for m in range(1, h + 1)}
    s = {m: -tw[m * nb].imag for m in range(1, h + 1)}
    a = {p: v[p] + v[radix - p] for p in range(1, h + 1)}
    b = {p: v[p] - v[radix - p] for p in range(1, h + 1)}
    out = np.empty_like(v)
    out[0] = v[0]
    for p in range(1, h + 1):
        out[0] = out[0] + a[p]
    for q in range(1, h + 1):
        big, small = v[0], 0
        for p in range(1, h + 1):
            m = p * q % radix
            big = big + (c[m] if m <= h else c[radix - m]) * a[p]
            small = small + (s[m] if m <= h else -s[radix - m]) * b[p]
        out[q], out[radix - q] = big - 1j * small, big + 1j * small
    return out


def fft(z, tw):
    """The P-point forward FFT of each row of z (..., P), natural order, by
    the kernel's Stockham passes."""
    p = z.shape[-1]
    ns = 1
    for radix in radices(p):
        nb = p // radix
        j = np.arange(nb)
        k = j % ns
        v = np.stack([z[..., j + r * nb] for r in range(radix)])
        if ns > 1:
            step = p // (ns * radix)
            for r in range(1, radix):
                v[r] = v[r] * tw[r * k * step]
        v = dft_radix(v, tw)
        out = np.empty_like(z)
        base = (j - k) * radix + k
        for r in range(radix):
            out[..., base + r * ns] = v[r]
        z, ns = out, ns * radix
    return z


def tables(c):
    as_c = lambda a: a.numpy()[..., 0] + 1j * a.numpy()[..., 1]  # noqa: E731
    return (c.window.numpy(), as_c(c.twiddles), as_c(c.split), c.mel_w.numpy(),
            c.bands.numpy(), c.bin_mels.numpy())


def split(za, zb, st):
    """X[k] from Z[k mod M], Z[(M - k) mod M] and e^(-2 pi i k / N)."""
    e = 0.5 * (za.real + zb.real) + 0.5j * (za.imag - zb.imag)
    o = 0.5 * (za.real - zb.real) + 0.5j * (za.imag + zb.imag)
    to = st * o
    return (e.real + to.imag) + 1j * (e.imag - to.real)


def spectrum(frames, c):
    """frames (..., N) fp64 -> (Z (..., P), X (..., f_used)): packing (even
    N), FFT, split (even N); an odd frame's X is Z's first f_used bins."""
    win, tw, st, *_ = tables(c)
    x = frames * win
    if frames.shape[-1] % 2:
        z = fft(x + 0j, tw)
        return z, z[..., :len(st)]
    z = fft(x[..., 0::2] + 1j * x[..., 1::2], tw)
    m = z.shape[-1]
    k = np.arange(len(st))
    return z, split(z[..., k % m], z[..., (m - k) % m], st)


def reflect(p, t, pad):
    """``reflect_index`` of the source: numpy's rule, period 2 (t - 1)."""
    q = np.asarray(p) - pad
    if t == 1:
        return np.zeros_like(q)
    period = 2 * (t - 1)
    inside = (q >= 0) & (q < t)
    m = q % period
    return np.where(inside, q, np.where(m < t, m, period - m))


def fold_order(s, t, pad):
    """The unpadded positions q the overlap-add kernel sums for sample s, in
    its order: s, then the class of -s modulo 2 (t - 1) ascending where it
    differs from s's, then the rest of s's class ascending."""
    lo, hi = -pad, t + pad - 1
    if t == 1:
        return [0] + [q for q in range(lo, hi + 1) if q != 0]
    period = 2 * (t - 1)

    def congruent(r):
        return list(range(r - (r - lo) // period * period, hi + 1, period))
    order = [s] + (congruent(-s) if 0 < s < t - 1 else [])
    return order + [q for q in congruent(s) if q != s]


def frames_of(wav, n_fft, hop, pad):
    """(B, frames, N) from the unpadded waveform, reflected by index."""
    b, t = wav.shape
    n_frames = mel_ops.n_frames(t, n_fft, hop, pad)
    p = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return wav[:, reflect(p, t, pad)]


def band_mel(mag, mel_w, bands, dtype):
    """Each mel's ascending sum over its band, fp32 fmaf (emulated: the
    product of two fp32 values is exact in fp64) or fp64."""
    out = np.zeros(mag.shape[:-1] + (len(bands),), dtype=dtype)
    for m, (k0, k1) in enumerate(bands):
        a = np.zeros(mag.shape[:-1], dtype=dtype)
        for k in range(k0, k1):
            a = (mel_w[m, k].astype(np.float64) * mag[..., k] + a).astype(dtype)
        out[..., m] = a
    return out


def twin_log_mel(wav, c, n_fft=1024, hop=256, pad=None, power_eps=0.0, log_floor=0.0,
                 log_offset=1e-6, lo=-np.inf, hi=np.inf, dtype=np.float32):
    """The forward kernel's result, (B, n_mels, frames); ``dtype`` float32 is
    the kernel's (magnitudes stored and the mel summed in fp32)."""
    pad = n_fft // 2 if pad is None else pad
    _, x = spectrum(frames_of(wav.astype(np.float64), n_fft, hop, pad), c)
    mag = np.sqrt(x.real ** 2 + x.imag ** 2 + power_eps).astype(dtype)
    _, _, _, mel_w, bands, _ = tables(c)
    mel = band_mel(mag, mel_w, bands, dtype)
    out = np.log(np.maximum(mel, log_floor)) if log_floor > 0 else np.log(mel + log_offset)
    return np.clip(out, lo, hi).astype(dtype).swapaxes(1, 2)


def twin_hifigan_backward(wav, grad, c, dtype=np.float32, n_fft=1024, hop=256):
    """K4's backward as the kernels compute it: wav (B, T), grad (B, 80,
    frames) -> dwav (B, T). ``dtype`` is that of the forward's mag and mel,
    and of dmel (the kernel's float32)."""
    b, t = wav.shape
    pad = (n_fft - hop) // 2
    win, tw, st, mel_w, bands, bin_mels = tables(c)
    f_used, m = len(st), lm.fft_size(n_fft)
    z, x = spectrum(frames_of(wav.astype(np.float64), n_fft, hop, pad), c)
    mag32 = np.sqrt(x.real ** 2 + x.imag ** 2 + 1e-9).astype(dtype)
    mel = band_mel(mag32, mel_w, bands, dtype)                 # (B, F, n_mels)
    g = grad.swapaxes(1, 2).astype(dtype)
    dmel = np.divide(g, mel, out=np.zeros_like(mel), where=mel >= 1e-5).astype(np.float64)

    # logmel_frame_grad_kernel: G per bin, then C, then one inverse FFT
    mag = np.sqrt(x.real ** 2 + x.imag ** 2 + 1e-9)
    dmag = np.zeros(x.shape)
    for k, (m0, m1) in enumerate(bin_mels):
        for mm in range(m0, m1):
            dmag[..., k] += mel_w[mm, k].astype(np.float64) * dmel[..., mm]
    gk = np.zeros(x.shape[:-1] + (m + 1,), dtype=np.complex128)
    gk[..., :f_used] = dmag / mag * x
    if n_fft % 2:                                              # odd N: C = G, one N-point FFT
        dframes = win * fft(np.conj(gk[..., :m]), tw).real
        return overlap_add(dframes, t, n_fft, hop, pad)
    kk = np.arange(m)
    inner = np.arange(1, min(f_used, m))
    a = gk[..., :m].copy()                                     # A[k] = G[k]
    bb = np.zeros_like(a)                                      # B[k] = G[k] e^(2 pi i k / N)
    bb[..., inner] = gk[..., inner] * np.conj(st[inner])
    a[..., 0] = gk[..., 0] + gk[..., m]                        # the Nyquist bin, folded
    bb[..., 0] = gk[..., 0] - gk[..., m]
    ar, br = a[..., (m - kk) % m], bb[..., (m - kk) % m]
    cc = 0.5 * (a + np.conj(ar)) + 0.5j * (bb + np.conj(br))
    y = fft(np.conj(cc), tw)                                   # DFT(conj C) = conj(c)
    dframes = np.empty(x.shape[:-1] + (n_fft,))
    dframes[..., 0::2] = win[0::2] * y.real
    dframes[..., 1::2] = -win[1::2] * y.imag
    return overlap_add(dframes, t, n_fft, hop, pad)


def overlap_add(dframes, t, n_fft, hop, pad):
    """logmel_overlap_add_kernel: every padded position that maps to s."""
    b, n_frames = dframes.shape[:2]
    padded = np.zeros((b, t + 2 * pad))
    for f in range(n_frames):
        padded[:, f * hop:f * hop + n_fft] += dframes[:, f]
    dwav = np.zeros((b, t))
    for s in range(t):
        for q in fold_order(s, t, pad):
            dwav[:, s] += padded[:, q + pad]
    return dwav


def consts(n_fft=1024, n_mels=80, fmax=8000.0):
    return lm._constants(SR, n_fft, n_fft, n_mels, 0.0, fmax, 'cpu')


def tones(rng, b, t):
    n = np.arange(t) / SR
    out = np.zeros((b, t))
    for i in range(b):
        f0 = rng.uniform(90, 300)
        for h in range(1, 12):
            out[i] += 0.4 / h * np.sin(2 * np.pi * f0 * h * n + rng.uniform(0, 2 * np.pi))
    return out.astype(np.float32)


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize('n_fft', [256, 512, 1024, 2048, 4096, 400, 1000, 300, 6000, 128,
                                   8192, 375])
def test_fft_plan_matches_rfft(n_fft):
    """Packing (even n_fft), the mixed-radix passes, twiddle table and split
    give the one-sided DFT of the windowed frame, every bin to N / 2, to
    1e-12 of the frame's norm: the power-of-two n_fft, the 7-smooth halves
    (400: radix 8, 5, 5; 1000: 4, 5, 5, 5; 300: 2, 3, 5, 5; 6000: 8, 3, 5,
    5, 5) and an odd n_fft (375: 3, 5, 5, 5, no packing)."""
    rng = np.random.default_rng(n_fft)
    c = lm._constants(SR, n_fft, n_fft, 40, 0.0, None, 'cpu')
    assert lm.fft_path(n_fft) and len(c.twiddles) == lm.fft_size(n_fft)
    every_bin = np.exp(-2j * np.pi * np.arange(n_fft // 2 + 1) / n_fft)
    c = c._replace(split=torch.from_numpy(np.stack([every_bin.real, every_bin.imag], -1)))
    frames = rng.standard_normal((3, n_fft))
    _, x = spectrum(frames, c)
    ref = torch.fft.rfft(torch.from_numpy(frames * c.window.numpy())).numpy()
    norm = np.linalg.norm(frames * c.window.numpy(), axis=-1, keepdims=True)
    assert float((np.abs(x - ref) / norm).max()) <= 1e-12


def bank_degrees(p, w):
    """Per pass of a P-point plan, the worst conflict (distinct addresses
    on one 16-byte slot mod 8) among the 8-lane phases of the block's
    shared-memory reads and writes: W frames of TF threads, each frame two
    buffers, lane l taking butterflies l, l + TF, ... (the first pass reads
    the span, not a buffer)."""
    tf, pad = threads(p), padded(p)
    frame = 2 * sidx(p, pad)
    out, ns = [], 1
    for n, radix in enumerate(radices(p)):
        nb, worst = p // radix, {'read': 1, 'write': 1}
        for kind in worst:
            if kind == 'read' and n == 0:
                continue
            for q in range(-(-8 // radix)):
                for r in range(radix):
                    lanes = np.arange(w * tf)
                    f, j = lanes // tf, lanes % tf + q * tf
                    k = j % ns
                    i = j + r * nb if kind == 'read' else (j - k) * radix + k + r * ns
                    addr = np.where(j < nb, f * frame + sidx(i, pad), -1)
                    for phase in addr.reshape(-1, 8):
                        live = np.unique(phase[phase >= 0])
                        if live.size:
                            worst[kind] = max(worst[kind], int(np.bincount(live % 8).max()))
        out.append((radix, worst['read'], worst['write']))
        ns *= radix
    return out


def test_radix_plan_and_shared_accesses():
    """The plans of ``plan_fft``, the threads (TF a frame, at most
    kMaxThreads, lanes striding over each pass's butterflies and over the
    backward's C items), and the shared-memory banks: where 8 | P (every
    power of two, 400's radix-5 plan, 6000's radix-3 / 5 plan) no access
    conflicts; elsewhere only the first pass's writes (4-way after radix 4,
    2-way after radix 2) and, for an odd P, the passes whose Ns is odd."""
    plans = {64: [8, 8], 128: [8, 8, 2], 256: [8, 8, 4], 512: [8, 8, 8], 1024: [8, 8, 8, 2],
             2048: [8, 8, 8, 4], 4096: [8, 8, 8, 8], 200: [8, 5, 5], 500: [4, 5, 5, 5],
             150: [2, 3, 5, 5], 3000: [8, 3, 5, 5, 5], 375: [3, 5, 5, 5], 2401: [7, 7, 7, 7],
             11: None, 4102: None}
    for p, plan in plans.items():
        assert radices(p) == plan, p
    assert 'for (int j = lane; j < nb; j += fp.tf) {' in SRC
    assert 'for (int k = lane; 2 * k <= P; k += tf) {' in SRC
    max_threads = kernel_constant('kMaxThreads')
    for p in range(2, kernel_constant('kMaxFftSize') + 1):
        if radices(p) is not None:
            tf = threads(p)
            assert tf <= max_threads and (tf < 8 or tf % 8 == 0), p
    for p in (64, 128, 512, 1024, 4096, 200, 3000):
        assert padded(p)
        assert all(rd == wr == 1 for _, rd, wr in bank_degrees(p, 2)), (p, bank_degrees(p, 2))
    assert not padded(500) and bank_degrees(500, 2) == [(4, 1, 4), (5, 1, 1), (5, 1, 1),
                                                          (5, 1, 1)]
    assert not padded(150) and bank_degrees(150, 2) == [(2, 1, 2), (3, 1, 1), (5, 1, 1),
                                                          (5, 1, 1)]
    odd = bank_degrees(375, 2)
    assert not padded(375) and odd[0] == (3, 1, 1) and odd[-1] == (5, 1, 1)
    assert all(rd == 1 for _, rd, _ in odd) and max(wr for *_, wr in odd) == 2


def held(got, jax_out, ref64):
    """Noise: the twin within TOL of the JAX kernel. Tones: the JAX kernel's
    fp32 contraction is itself up to ~1e-3 from the exact value in quiet
    bands, so the twin is held to the plain version in fp64 at 1e-6, and to
    the JAX kernel at TOL wherever that is within TOL / 2 of fp64."""
    assert got.shape == jax_out.shape == ref64.shape
    assert float(np.abs(got - ref64).max()) <= 1e-6
    near = np.abs(jax_out - ref64) <= TOL / 2
    np.testing.assert_allclose(got[near], jax_out[near], atol=TOL, rtol=0)


@pytest.mark.parametrize('signal', ['noise', 'tones'])
@pytest.mark.parametrize('shape', [(2, 9000), (2, 640)])
def test_twin_matches_jax_hifigan_mel(signal, shape):
    """HiFi-GAN convention, pad 384 (t = 640 is two frames: the reflection of
    both edges reaches across the whole input)."""
    rng = np.random.default_rng(5)
    wav = (rng.standard_normal(shape) * 0.2).astype(np.float32) if signal == 'noise' \
        else tones(rng, *shape)
    got = twin_log_mel(wav, consts(), pad=384, power_eps=1e-9, log_floor=1e-5)
    ref = np.asarray(jax_fused_hifigan_mel(jnp.asarray(wav), precision='highest'))
    assert got.shape == ref.shape == (shape[0], 80, shape[1] // 256)
    if signal == 'noise':
        np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    else:
        held(got, ref, mel_ops.hifigan_mel_spectrogram(
            torch.from_numpy(wav).double()).numpy())


@pytest.mark.parametrize('fmax,f_used', [(8000.0, 372), (None, 512), (12000.0, 513)])
def test_twin_matches_jax_centered_log_mel(fmax, f_used):
    """Centered convention with the dB clip. At fmax None the Slaney
    filterbank weights every bin but the Nyquist one; at 12 kHz its top
    filters reach past sr / 2 and weight that bin too (the split at
    k = N / 2 reads Z[0] twice)."""
    rng = np.random.default_rng(6)
    wav = np.concatenate([(rng.standard_normal((1, 5000)) * 0.2).astype(np.float32),
                          tones(rng, 1, 5000)])
    c = consts(fmax=fmax)
    assert c.mel_w.shape[1] == f_used
    lo, hi = mel_ops.db_to_log(-100.0), mel_ops.db_to_log(20.0)
    got = twin_log_mel(wav, c, lo=lo, hi=hi)
    ref = np.asarray(jax_fused_log_mel(jnp.asarray(wav), mel_max=fmax, min_db=-100.0,
                                       max_db=20.0, precision='highest'))
    assert got.shape == ref.shape == (2, 80, 1 + 5000 // 256)
    np.testing.assert_allclose(got[:1], ref[:1], atol=TOL, rtol=0)
    held(got[1:], ref[1:], mel_ops.log_mel_spectrogram(
        torch.from_numpy(wav[1:]).double(), SR, 80, 1024, 1024, 256, min_db=-100.0,
        max_db=20.0, mel_max=fmax).numpy())


@pytest.mark.parametrize('shape', [(2, 3000), (1, 640), (1, 385), (2, 384), (1, 300),
                                   (1, 256)])
def test_backward_twin_matches_fp64_autograd(shape):
    """With the mel in fp64, the twin's backward is the VJP of the port's
    plain composite in fp64 to 1e-10 of the gradient's largest entry: the
    adjoint of the trimmed DFT by one inverse FFT, the Nyquist fold, the
    overlap-add and both mirrors of the reflect pad (t = 385 = pad + 1), and
    the further reflections of a pad >= t (t = 384, 300, 256)."""
    rng = np.random.default_rng(shape[1])
    wav = (rng.standard_normal(shape) * 0.2).astype(np.float32)
    w = torch.from_numpy(wav.astype(np.float64)).requires_grad_(True)
    mel = mel_ops.hifigan_mel_spectrogram(w)
    cot = rng.standard_normal(tuple(mel.shape))
    ref, = torch.autograd.grad(mel, w, torch.from_numpy(cot))
    got = twin_hifigan_backward(wav, cot, consts(), dtype=np.float64)
    ref = ref.numpy()
    assert float(np.abs(got - ref).max()) <= 1e-10 * float(np.abs(ref).max())


def test_backward_twin_nyquist_bin_matches_fp64_autograd():
    """The same with every bin to N / 2 used (fmax 12 kHz, past sr / 2): the
    Nyquist bin folds into k = 0 with e^(i pi) = -1."""
    rng = np.random.default_rng(9)
    wav = (rng.standard_normal((1, 2000)) * 0.2).astype(np.float32)
    c = consts(fmax=12000.0)
    assert c.mel_w.shape[1] == 513
    w = torch.from_numpy(wav.astype(np.float64)).requires_grad_(True)
    mel = mel_ops.log_mel(w, c.mel_w.numpy(), 1024, 256, 1024, 384, 1e-9, 1e-5)
    cot = rng.standard_normal(tuple(mel.shape))
    ref, = torch.autograd.grad(mel, w, torch.from_numpy(cot))
    got = twin_hifigan_backward(wav, cot, c, dtype=np.float64)
    ref = ref.numpy()
    assert float(np.abs(got - ref).max()) <= 1e-10 * float(np.abs(ref).max())


@pytest.mark.parametrize('signal', ['noise', 'tones'])
def test_backward_twin_matches_jax_grad(signal):
    """The kernel's backward (fp32 mel) against jax.grad of JAX's K4 at
    'highest', loss sum(sin(mel)) (tests/test_torch_mel_trainable.py:24).
    On tones the gradient reaches ~5e3 through 1 / mel in quiet bands, where
    JAX's fp32 forward is ~1e-3 off: there the twin is held to fp64 autograd
    of the plain composite at 1e-6 of the largest entry, and to JAX within
    JAX's own distance from fp64 plus TOL of the largest entry."""
    rng = np.random.default_rng(12)
    wav = (rng.standard_normal((2, 9000)) * 0.2).astype(np.float32) if signal == 'noise' \
        else tones(rng, 2, 9000)
    ref = np.asarray(jax.grad(lambda w: jnp.sum(jnp.sin(jax_trainable(w, 'highest'))))(
        jnp.asarray(wav)))
    mel = twin_log_mel(wav, consts(), pad=384, power_eps=1e-9, log_floor=1e-5)
    got = twin_hifigan_backward(wav, np.cos(mel), consts())
    if signal == 'noise':
        assert float(np.abs(got - ref).max()) <= TOL
        return
    w = torch.from_numpy(wav.astype(np.float64)).requires_grad_(True)
    ref64, = torch.autograd.grad(mel_ops.hifigan_mel_spectrogram(w), w,
                                 torch.from_numpy(np.cos(mel).astype(np.float64)))
    ref64 = ref64.numpy()
    scale = float(np.abs(ref64).max())
    assert float(np.abs(got - ref64).max()) <= 1e-6 * scale
    assert float(np.abs(got - ref).max()) <= float(np.abs(ref - ref64).max()) + TOL * scale


@pytest.mark.parametrize('t,pad', [(1, 384), (2, 384), (3, 5), (255, 384), (384, 384),
                                   (385, 384), (640, 384), (5, 0), (1, 0)])
def test_fold_order_covers_each_padded_position_once(t, pad):
    """The overlap-add kernel's enumeration reaches every padded position
    exactly once, at the sample the forward's ``reflect_index`` read it
    from; for pad < t it is the order the single reflection had (s, left
    mirror, right mirror)."""
    seen = []
    for s in range(t):
        order = fold_order(s, t, pad)
        assert order[0] == s and all(int(reflect(q + pad, t, pad)) == s for q in order)
        seen += order
    assert sorted(seen) == list(range(-pad, t + pad))
    np.testing.assert_array_equal(reflect(np.arange(t + 2 * pad), t, pad),
                                  mel_ops.reflect_index(t, pad))
    if pad < t:
        for s in range(t):
            single = [s] + [q for q in (-s, 2 * (t - 1) - s)
                            if q != s and -pad <= q < t + pad]
            assert fold_order(s, t, pad) == single


@pytest.mark.parametrize('t', [1, 2, 255, 256, 383, 384, 385])
def test_twin_short_inputs_match_plain_fp64(t):
    """Inputs the pad reflects more than once: the twin's frames and values
    against the port's plain version in fp64 (HiFi-GAN convention; and
    centered, the dB clip off), (B, 80, 0) below one frame."""
    rng = np.random.default_rng(t)
    wav = (rng.standard_normal((2, t)) * 0.2).astype(np.float32)
    w64 = torch.from_numpy(wav).double()
    got = twin_log_mel(wav, consts(), pad=384, power_eps=1e-9, log_floor=1e-5)
    ref = mel_ops.hifigan_mel_spectrogram(w64).numpy()
    assert got.shape == ref.shape == (2, 80, max(0, 1 + (t - 256) // 256))
    assert got.size == 0 or float(np.abs(got - ref).max()) <= 1e-6
    got = twin_log_mel(wav, consts())
    ref = mel_ops.log_mel_spectrogram(w64, SR, 80, 1024, 1024, 256, mel_max=8000.0).numpy()
    assert got.shape == ref.shape == (2, 80, 1 + t // 256)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_band_sum_equals_dense_sum():
    """The band-limited mel sum is the dense ascending fp32 sum, bit for bit:
    a zero weight adds an exact zero."""
    rng = np.random.default_rng(2)
    c = consts()
    mel_w, bands = c.mel_w.numpy(), c.bands.numpy()
    mag = (rng.random((64, mel_w.shape[1])) * 10.0 ** rng.uniform(-6, 2, (64, 1))
           ).astype(np.float32)
    dense = np.tile(np.array([[0, mel_w.shape[1]]], dtype=np.int32), (len(bands), 1))
    np.testing.assert_array_equal(band_mel(mag, mel_w, bands, np.float32),
                                  band_mel(mag, mel_w, dense, np.float32))
    assert int((bands[:, 1] - bands[:, 0]).sum()) == int((mel_w != 0).sum())


@pytest.mark.parametrize('sr,n_fft,hop', [(16000, 400, 100), (22050, 1000, 250),
                                         (16000, 300, 100), (16000, 375, 125), (8000, 128, 32),
                                         (22050, 750, 250)])
def test_mixed_radix_backward_twin_matches_fp64_autograd(sr, n_fft, hop):
    """K4's backward off the power-of-two n_fft: with the mel in fp64, the
    twin (recompute, G, one P-point inverse FFT by the mixed-radix passes,
    the overlap-add) is the VJP of the port's plain composite in fp64 to
    1e-10 of the gradient's largest entry; at an odd P from an even n_fft
    (750: the C items pair k with P - k up to (P - 1) / 2) and at an odd
    n_fft (375: C = G, no Nyquist fold)."""
    rng = np.random.default_rng(n_fft)
    wav = (rng.standard_normal((2, 6 * n_fft + 13)) * 0.2).astype(np.float32)
    c = lm._constants(sr, n_fft, n_fft, 80, 0.0, 8000.0, 'cpu')
    pad = (n_fft - hop) // 2
    w = torch.from_numpy(wav.astype(np.float64)).requires_grad_(True)
    mel = mel_ops.log_mel(w, mel_ops.cached_mel_filter(sr, n_fft, 80, 0.0, 8000.0), n_fft, hop,
                          n_fft, pad, 1e-9, 1e-5)
    cot = rng.standard_normal(tuple(mel.shape))
    ref, = torch.autograd.grad(mel, w, torch.from_numpy(cot))
    got = twin_hifigan_backward(wav, cot, c, dtype=np.float64, n_fft=n_fft, hop=hop)
    ref = ref.numpy()
    assert float(np.abs(got - ref).max()) <= 1e-10 * float(np.abs(ref).max())


@pytest.mark.parametrize('signal', ['noise', 'tones'])
def test_twin_matches_jax_at_16k_400_100(signal):
    """n_fft 400, hop 100 at 16 kHz (a 25 ms window, a 6.25 ms hop; radix
    8, 5, 5) in both conventions against JAX's fused_log_mel (Pallas in
    interpret mode): noise within TOL, tones as ``held``."""
    rng = np.random.default_rng(16)
    t = 8017
    if signal == 'noise':
        wav = (rng.standard_normal((2, t)) * 0.2).astype(np.float32)
    else:
        n = np.arange(t) / 16000
        f0 = rng.uniform(90, 300, (2, 1))
        wav = sum(0.4 / h * np.sin(2 * np.pi * f0 * h * n) for h in range(1, 12)).astype(
            np.float32)
    c = lm._constants(16000, 400, 400, 80, 0.0, 8000.0, 'cpu')
    lo, hi = mel_ops.db_to_log(-100.0), mel_ops.db_to_log(20.0)
    filt = mel_ops.cached_mel_filter(16000, 400, 80, 0.0, 8000.0)
    w64 = torch.from_numpy(wav).double()
    for kw, twin_kw, plain_kw in (
            (dict(min_db=-100.0, max_db=20.0), dict(lo=lo, hi=hi),
             dict(pad=200, lo=lo, hi=hi)),
            (dict(pad=150, power_eps=1e-9, log_floor=1e-5),
             dict(pad=150, power_eps=1e-9, log_floor=1e-5),
             dict(pad=150, power_eps=1e-9, log_floor=1e-5))):
        got = twin_log_mel(wav, c, n_fft=400, hop=100, **twin_kw)
        ref = np.asarray(jax_fused_log_mel(jnp.asarray(wav), 16000, 80, 400, 400, 100,
                                           mel_max=8000.0, precision='highest', **kw))
        assert got.shape == ref.shape == (2, 80, got.shape[-1]) and got.shape[-1] >= 78
        if signal == 'noise':
            np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
        else:
            held(got, ref, mel_ops.log_mel(w64, filt, 400, 100, 400, **plain_kw).numpy())


def test_kernel_geometry_guard():
    """The kernels take the JAX kernel's geometry, hop | n_fft and win ==
    n_fft: the FFT path (the source's ``fft_geometry``: ``make_plan`` gives
    a plan) for every n_fft whose FFT size, n_fft / 2 if even and n_fft if
    odd, is 7-smooth from 2 to kMaxFftSize points; ``fft_path`` agrees with
    the source's plan at every n_fft to 9000, and every n_fft compiled for
    its own plan (kStaticNfft) is on it; the CPU path takes every geometry
    it took."""
    assert 'bool fft_geometry(int n_fft) { return make_plan(n_fft).p != 0; }' in SRC
    body = plan_body()
    assert 'const int p = odd ? n_fft : n_fft / 2;' in body
    assert 'if (p < 2 || p > kMaxFftSize) return FftPlan{0, 0, 0, odd, false, 0};' in body
    assert 'if (rest != 1) return FftPlan{0, 0, 0, odd, false, 0};' in body
    static = [int(n) for n in re.search(r'constexpr int kStaticNfft\[\] = \{([\d, ]+)\};',
                                        SRC).group(1).split(',')]
    assert static == [256, 512, 1024, 2048, 4096, 400] and all(map(lm.fft_path, static))
    for i in range(len(static)):
        assert ('case kStaticNfft[%d]: return f(std::integral_constant<int, kStaticNfft[%d]>{});'
                % (i, i)) in SRC
    # the powers of two compiled for their own plan keep one buffer a frame
    # (TF = P / 8: each lane holds 8 / R butterflies of a pass), their
    # kernels are bound to kPow2Threads threads a block and plan() caps
    # their blocks there; every other n_fft has two buffers and kMaxThreads
    assert 'return nfft > 0 && (nfft & (nfft - 1)) == 0;' in SRC
    assert 'return one_buffer(nfft) ? kPow2Threads : kMaxThreads;' in SRC
    assert SRC.count('__launch_bounds__(max_block_threads(NFFT))') == 2
    assert 'const int max_threads = max_block_threads(static_nfft(n_fft));' in SRC
    assert 'one_buffer(static_nfft(n_fft)) ? 1 : 2};' in SRC
    for n in static:
        if not n & (n - 1):
            p = lm.fft_size(n)
            assert threads(p) * 8 == p and threads(p) <= kernel_constant('kPow2Threads')
            assert set(radices(p)) <= {8, 4, 2}, n
    assert kernel_constant('kMaxFftSize') == lm.FFT_MAX_SIZE
    for n_fft in range(1, 9001):
        p = lm.fft_size(n_fft)
        assert p == (n_fft // 2 if n_fft % 2 == 0 else n_fft)
        assert lm.fft_path(n_fft) == (2 <= p <= lm.FFT_MAX_SIZE and radices(p) is not None), n_fft
    for n_fft, hop in ((256, 128), (1024, 256), (4096, 1024), (400, 100), (1000, 250),
                       (128, 32), (8192, 2048), (300, 100), (6000, 3), (375, 125), (16, 4)):
        lm._kernel_geometry(n_fft, hop, n_fft)
        assert lm.fft_path(n_fft), n_fft
    for n_fft, hop in ((802, 401), (22, 11), (1102, 551), (2, 1), (1, 1), (8194, 2),
                       (4375, 875)):
        lm._kernel_geometry(n_fft, hop, n_fft)
        assert not lm.fft_path(n_fft), n_fft
    for n_fft, hop, win in ((1024, 384, 1024), (1024, 256, 800), (400, 0, 400)):
        with pytest.raises(ValueError, match='geometry'):
            lm._kernel_geometry(n_fft, hop, win)
    wav = torch.from_numpy((np.random.default_rng(0).standard_normal((1, 4000)) * 0.2)
                           .astype(np.float32))
    out = lm.fused_log_mel(wav, n_fft=1000, win_length=1000, hop_length=250)
    assert out.shape == (1, 80, 1 + 4000 // 250) and bool(torch.isfinite(out).all())


# ---------------------------------------------------------------- the direct path

def twin_direct_spectrum(frames, c):
    """The direct path's sums (``direct_spectrum``): per used bin k, the
    windowed samples times the twiddle z, run as the recurrence
    z <- z e^(-2 pi i k / N) and re-read from the N-point table every kSync
    steps at index k n0 mod N. frames (..., N) fp64 -> X (..., f_used)."""
    win, tw, st, *_ = tables(c)
    n, sync = frames.shape[-1], kernel_constant('kSync')
    k = np.arange(len(st))
    assert re.search(r'c\.tw \+ static_cast<long long>\(k\) \* n0 % n_fft', SRC)
    x = np.zeros(frames.shape[:-1] + (len(k),), dtype=np.complex128)
    for n0 in range(0, n, sync):
        z = tw[k * n0 % n]
        for j in range(n0, min(n0 + sync, n)):
            x += frames[..., j:j + 1] * (z * win[j])
            z = z * tw[k]
    return x


def twin_direct_adjoint(g, c):
    """The direct backward's adjoint (``logmel_direct_grad_kernel``): per
    sample n, w[n] Re sum_k G[k] e^(+2 pi i k n / N), the twiddle by the
    recurrence over k re-read every kSync bins. g (..., f_used) -> (..., N)."""
    win, tw, *_ = tables(c)
    n_fft, f_used, sync = len(win), g.shape[-1], kernel_constant('kSync')
    n = np.arange(n_fft)
    acc = np.zeros(g.shape[:-1] + (n_fft,))
    for k0 in range(0, f_used, sync):
        z = np.conj(tw[k0 * n % n_fft])
        for k in range(k0, min(k0 + sync, f_used)):
            acc += g[..., k:k + 1].real * z.real - g[..., k:k + 1].imag * z.imag
            z = z * np.conj(tw[n])
    return win * acc


@pytest.mark.parametrize('sr,n_fft,fmax', [(16000, 802, None), (22050, 22, None),
                                          (16000, 254, None), (44100, 1102, 8000.0),
                                          (16000, 143, None)])
def test_direct_twin_matches_rfft_and_its_adjoint(sr, n_fft, fmax):
    """The direct path's n_fft (a prime factor above 7 in the FFT size: 802
    = 2 * 401, 22, 254 = 2 * 127, 1102 = 2 * 19 * 29, odd 143 = 11 * 13), its
    tables (the N-point twiddles), its recurrence against numpy's rfft and
    its adjoint against the explicit transposed DFT, both within 1e-12 of
    the norms: the drift of kSync recurrence steps is ~1e-15."""
    c = lm._constants(sr, n_fft, n_fft, 40, 0.0, fmax, 'cpu')
    assert not lm.fft_path(n_fft) and tuple(c.twiddles.shape) == (n_fft, 2)
    win, tw, st, *_ = tables(c)
    np.testing.assert_array_equal(tw, np.exp(-2j * np.pi * np.arange(n_fft) / n_fft))
    f_used = len(st)
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((2, n_fft))
    x = twin_direct_spectrum(frames, c)
    ref = np.fft.rfft(frames * win)[..., :f_used]
    assert float(np.abs(x - ref).max()) <= 1e-12 * float(np.linalg.norm(frames))
    g = rng.standard_normal((2, f_used)) + 1j * rng.standard_normal((2, f_used))
    k, n = np.arange(f_used)[:, None], np.arange(n_fft)[None, :]
    ref = win * (g @ np.exp(2j * np.pi * k * n / n_fft)).real
    assert float(np.abs(twin_direct_adjoint(g, c) - ref).max()) <= \
        1e-12 * float(np.abs(g).sum())
