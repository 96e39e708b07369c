"""Dataset preprocessing CLI: ``python -m pytorch_sound_tpu_torch.scripts.preprocess
<command> ...``; the port's copy of ``pytorch_sound_tpu/scripts/preprocess.py``.

The host half (decode, RMS normalisation, resampling, chunking into .npy,
metas) is the JAX package's, with joblib replaced by a thread pool
(``utils.commons.go_multiprocess``) and tqdm by plain prints; WAV files are
read in-process, other codecs through ffmpeg where it is installed. The
outputs that exist are skipped, so a run can restart. Commands ported:
``copy_txt``, ``preprocess_audio``, ``resample_audio``, ``voice_bank``,
``vctk``, ``ljspeech``, ``dsd100`` and ``extract_features``. ``dsd100`` keys
its outputs by subset and song (``<out>/<subset>/<song>/``), where the JAX
package keys them by song alone and lets Dev and Test songs of one name
overwrite each other. The commands whose metas are not ported yet
(valenti, musdb18, medleydb, partialize, zeroth_korean, libri_light,
libri_light2, libri_tts, libri_tts_fetch_speaker) are not defined.

``extract_features`` is the feature pipeline on the card: a tree of WAVs at
their source rates -> the native runtime's decode into one int16 (or target
rate int16 / mu-law-8) matrix per batch -> pinned host memory -> a side
stream's copy -> on the card, the resample to ``sample_rate``
(:func:`~pytorch_sound_tpu_torch.ops.resample.resample_poly`), RMS
normalisation and the log-mel kernel K2
(:func:`~pytorch_sound_tpu_torch.ops.cuda.logmel.fused_log_mel`) -> the
bf16, f32 or int8 wire back into pinned memory -> one ``<name>.mel.npy``
of shape (80, n // 256 + 1) per utterance.
"""

import contextlib
import csv
import glob
import os
import queue
import shutil
import struct
import subprocess
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pytorch_sound_tpu_torch import native, settings
from pytorch_sound_tpu_torch.data.meta.dsd100 import DSD100Meta
from pytorch_sound_tpu_torch.data.meta.ljspeech import LJSpeechMeta
from pytorch_sound_tpu_torch.data.meta.vctk import VCTKMeta
from pytorch_sound_tpu_torch.data.meta.voice_bank import VoiceBankMeta
from pytorch_sound_tpu_torch.ops.cuda.logmel import fused_log_mel
from pytorch_sound_tpu_torch.ops.resample import resample_out_len, resample_poly
from pytorch_sound_tpu_torch.ops.resample import rms_normalize as rms_normalize_rows
from pytorch_sound_tpu_torch.parallel.prefetch import PinnedCopier, PinnedPool, pinned_view
from pytorch_sound_tpu_torch.utils import wavio
from pytorch_sound_tpu_torch.utils.commons import go_multiprocess

RMS_TARGET_DB = -23.0   # ffmpeg-normalize rms default target level
WIRES = ('bf16', 'f32', 'int8')
H2D_WIRES = ('i16_src', 'i16_tgt', 'mulaw8_tgt')


def _decode_any(in_file: str) -> Tuple[np.ndarray, int]:
    """Decode an audio file to mono float32. WAV in-process; other codecs
    through ffmpeg where it is installed."""
    if in_file.lower().endswith('.wav'):
        return wavio.load_wav(in_file, sr=None)
    if shutil.which('ffmpeg'):
        out = subprocess.run(['ffmpeg', '-v', 'error', '-i', in_file, '-f', 'f32le',
                              '-ac', '1', '-'], capture_output=True, check=True)
        probe = subprocess.run(['ffprobe', '-v', 'error', '-show_entries', 'stream=sample_rate',
                                '-of', 'csv=p=0', in_file], capture_output=True, check=True)
        sr = int(probe.stdout.decode().strip().splitlines()[0])
        return np.frombuffer(out.stdout, dtype=np.float32), sr
    raise RuntimeError('{}: non-WAV input needs ffmpeg, which is unavailable'.format(in_file))


def rms_normalize(wav: np.ndarray, target_db: float = RMS_TARGET_DB) -> np.ndarray:
    """Scale to the target RMS level in dBFS (ffmpeg-normalize 'rms' mode)."""
    rms = np.sqrt(np.mean(np.square(wav), dtype=np.float64))
    if rms < 1e-10:
        return wav
    gain = 10 ** (target_db / 20.0) / rms
    return (wav * gain).astype(np.float32)


def process_all(in_file: str, out_file: str, out_sr: int):
    """Decode -> resample -> RMS normalize -> float32 WAV (skip if it exists).
    A file that fails is reported and skipped, as in the JAX package."""
    if os.path.exists(out_file):
        return
    try:
        wav, sr = _decode_any(in_file)
        # resample first so the RMS target holds on the written signal
        wav = wavio.resample(wav, sr, out_sr)
        wavio.write_wav(out_file, rms_normalize(wav), out_sr, dtype='float32')
    except (OSError, ValueError, RuntimeError, NotImplementedError, struct.error) as e:
        print('Failed to process {}: {!r}'.format(in_file, e))


def resample(in_file: str, out_file: str, out_sr: int):
    """Polyphase resample to a new rate (skip if the output exists)."""
    if os.path.exists(out_file):
        return
    wav, sr = _decode_any(in_file)
    wavio.write_wav(out_file, wavio.resample(wav, sr, out_sr), out_sr)


def load_split_numpy(in_file: str, out_file: str, wav_len: int):
    """Chunk a long audio file into fixed-length .npy shards."""
    wav, _ = _decode_any(in_file)
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    for idx in range(0, len(wav) - wav_len, wav_len):
        np.save(out_file.replace('.npy', '.{}.npy'.format(idx)), wav[idx: idx + wav_len])


def make_background_numpy(mixture_file: str, vocal_file: str, out_file: str, wav_len: int):
    """background = mixture - vocal, chunked into fixed-length .npy shards."""
    mixture_wav, _ = _decode_any(mixture_file)
    vocal_wav, _ = _decode_any(vocal_file)
    background_wav = mixture_wav - vocal_wav
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    for idx in range(0, len(background_wav) - wav_len, wav_len):
        np.save(out_file.replace('.npy', '.{}.npy'.format(idx)),
                background_wav[idx: idx + wav_len])


def load_and_numpy_audio(in_file: str, out_file: str):
    """Audio file -> mono .npy."""
    try:
        wav, _ = _decode_any(in_file)
        np.save(out_file, wav[0] if wav.ndim > 1 else wav)
    except (OSError, ValueError, RuntimeError, NotImplementedError, struct.error):
        print('Failed to convert on {}'.format(str((in_file, out_file))))


def read_and_write(in_file: str, out_file: str):
    """Copy a text file."""
    with open(in_file, 'r') as r, open(out_file, 'w') as w:
        w.write(r.read())


def get_sub_paths(in_dir: str, file_path: str) -> str:
    """Path of ``file_path`` relative to ``in_dir``."""
    sub = file_path.replace(os.path.abspath(in_dir), '')
    return sub[1:] if sub.startswith('/') else sub


def get_sub_dir(in_dir: str, file_path: str) -> str:
    return os.path.dirname(get_sub_paths(in_dir, file_path))


def partialize_npy_wave(npy_path: str, num_partial_sample: int, min_partial_length: int = 0):
    """Split one long .npy wave into numbered fixed-length partials."""
    arr = np.load(npy_path)
    if arr.ndim > 1:
        arr = arr[0]
    num_partial_sample = int(num_partial_sample)
    partial_path_list = []
    for idx, start_idx in enumerate(range(0, len(arr), num_partial_sample)):
        partial_out_path = npy_path.replace('.npy', '_{:05d}.npy'.format(idx + 1))
        partial_arr = arr[start_idx:start_idx + num_partial_sample]
        if min_partial_length and len(partial_arr) < min_partial_length:
            continue
        np.save(partial_out_path, partial_arr)
        partial_path_list.append(partial_out_path)
    return npy_path, partial_path_list


# ---------------------------------------------------------------- feature extraction

def tail_context(src_sr: int, sample_rate: int, host_resample: bool) -> int:
    """Samples at the wire's rate that cover the centred log-mel's half
    window (n_fft / 2 target samples), mirrored into each row's zero tail."""
    if host_resample:
        return settings.N_FFT // 2 + 4
    return -(-(settings.N_FFT // 2) * src_sr // sample_rate) + 4


def reflect_tail(mat: np.ndarray, raw_lens, tail_ext: int) -> np.ndarray:
    """Mirror up to ``tail_ext`` samples before each row's end into its zero
    tail, in place, at the source rate: the last frames then see a reflect
    pad's context, as the reference's resample-then-pad pipeline gives them
    (approximately: the JAX package mirrors at the source rate, and so does
    this copy). A row that fills the matrix gets none."""
    for i, n in enumerate(raw_lens):
        n = int(n)
        e = min(tail_ext, n - 1, mat.shape[1] - n)
        if e > 0:
            mat[i, n:n + e] = mat[i, n - e - 1:n - 1][::-1]
    return mat


def decode_batch(paths: List[str], src_sr: int, sample_rate: int, pad_len: int,
                 h2d: str = 'i16_src') -> Tuple[Optional[np.ndarray], List[int], List[str]]:
    """One batch on the host: (wire matrix or None, lengths at
    ``sample_rate``, names). The native loader decodes every file in
    parallel; files it cannot read are dropped with their names, and a batch
    with none left gives None."""
    names = [os.path.splitext(os.path.basename(p))[0] for p in paths]
    host_resample = h2d != 'i16_src'
    tail_ext = tail_context(src_sr, sample_rate, host_resample)
    if host_resample:
        # one C pass: decode -> resample -> reflect-tail -> quantize
        mat, raw_lens = native.batch_load_wire(
            paths, sample_rate, pad_len, mode='mulaw8' if h2d == 'mulaw8_tgt' else 'i16',
            tail_ext=tail_ext)
        keep = raw_lens >= 0
        lens = [int(n) for n in raw_lens[keep]]
    else:
        mat, raw_lens, _ = native.batch_load_i16(paths, pad_len)
        keep = raw_lens >= 0
        lens = [resample_out_len(int(n), src_sr, sample_rate) for n in raw_lens[keep]]
    mat, kept = mat[keep], [nm for nm, k in zip(names, keep) if k]
    if not len(mat):
        return None, lens, kept
    if not host_resample:
        reflect_tail(mat, raw_lens[keep], tail_ext)
    return mat, lens, kept


def _unwire(x: torch.Tensor) -> torch.Tensor:
    """The audio wire as float32: int16 / 32768, or mu-law-256 expanded."""
    if x.dtype == torch.int16:
        return x.float() * (1.0 / 32768.0)
    if x.dtype == torch.uint8:
        mu = 255.0
        yq = x.float() * (2.0 / mu) - 1.0
        return torch.sign(yq) * ((torch.pow(1.0 + mu, yq.abs()) - 1.0) / mu)
    return x.float()


def batch_audio(x: torch.Tensor, lengths: torch.Tensor, src_sr: int,
                sample_rate: int) -> torch.Tensor:
    """The batch program's audio: the wire unpacked, resampled from
    ``src_sr`` (the wire's rate) to ``sample_rate``, and each row RMS
    normalised to -23 dBFS over its true ``lengths`` (the mirrored tail,
    at most n_fft / 2 samples, adds under 0.2 % of gain bias at 1 s and
    more)."""
    y = resample_poly(_unwire(x), src_sr, sample_rate)
    return rms_normalize_rows(y, lengths=lengths, target_db=RMS_TARGET_DB).contiguous()


def feature_program(x: torch.Tensor, lengths: torch.Tensor, src_sr: int, sample_rate: int,
                    precision: str = 'bf16x3', wire: str = 'bf16') -> Tuple[torch.Tensor, ...]:
    """One batch on the card (or the CPU): :func:`batch_audio`, the log-mel
    kernel at the ``settings.py`` defaults (centred, 80 mels, 0-8 kHz,
    clipped to -50 .. 30 dB), and the wire back: the mel as float32 or
    bfloat16, or for 'int8' (q, (B, 2) scale and offset) from a per-row
    affine quantisation over each row's valid frames only."""
    with torch.inference_mode():
        y = batch_audio(x, lengths, src_sr, sample_rate)
        mel = fused_log_mel(y, sample_rate, settings.MEL_SIZE, settings.N_FFT,
                            settings.WIN_LENGTH, settings.HOP_LENGTH, settings.MIN_DB,
                            settings.MAX_DB, settings.MEL_MIN, settings.MEL_MAX,
                            precision=precision)
        if wire == 'int8':
            # padded-tail frames sit at MIN_DB and would widen the range
            n_fr = lengths.long() // settings.HOP_LENGTH + 1
            valid = (torch.arange(mel.shape[2], device=mel.device)[None, None, :]
                     < n_fr[:, None, None])
            mn = torch.where(valid, mel, float('inf')).amin(dim=(1, 2), keepdim=True)
            mx = torch.where(valid, mel, float('-inf')).amax(dim=(1, 2), keepdim=True)
            scale = torch.clamp(mx - mn, min=1e-6) / 254.0
            q = torch.round((torch.minimum(torch.maximum(mel, mn), mx) - mn) / scale - 127.0)
            return q.to(torch.int8), torch.cat([scale[:, 0, :], mn[:, 0, :]], dim=-1)
        return (mel.to(torch.bfloat16) if wire == 'bf16' else mel,)


def _to_host(outputs: Tuple[torch.Tensor, ...], pool: Optional[PinnedPool]):
    """Start the device -> host copies of a batch's outputs into pinned
    buffers (on the current stream, after the program); returns (buffers,
    host tensors, start event, end event). On the CPU the outputs are the
    host tensors."""
    if pool is None:
        return [], list(outputs), None, None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    bufs, host = [], []
    for t in outputs:
        buf, view = pinned_view(pool, t.shape, t.dtype)
        view.copy_(t, non_blocking=True)
        bufs.append(buf)
        host.append(view)
    end.record()
    return bufs, host, start, end


def _mel_arrays(host: List[torch.Tensor]) -> np.ndarray:
    """The wire's host tensors as float32 (B, 80, frames): bf16 widened
    exactly, int8 dequantised as the JAX package does in numpy."""
    if len(host) == 2:
        aff = host[1].numpy()
        scale, mn = aff[:, :1, None], aff[:, 1:, None]
        return (host[0].numpy().astype(np.float32) + 127.0) * scale + mn
    return host[0].float().numpy()


class Processor:
    """fire-style CLI over per-dataset preprocessing pipelines."""

    num_workers = max(1, (os.cpu_count() or 2) // 2)

    @staticmethod
    def copy_txt(in_dir: str, out_dir: str):
        """Copy all text files, preserving subdirectories."""
        print('Lookup file list...')
        in_txt_list = glob.glob(os.path.join(in_dir, '**', '*.txt'), recursive=True)
        print('Start to make sub directories...')
        for d in {os.path.join(out_dir, get_sub_dir(in_dir, p)) for p in in_txt_list}:
            os.makedirs(d, exist_ok=True)
        out_txt_list = [os.path.join(out_dir, get_sub_paths(in_dir, p)) for p in in_txt_list]
        go_multiprocess(read_and_write, list(zip(in_txt_list, out_txt_list)),
                        Processor.num_workers)

    @staticmethod
    def _get_wave_file_list(in_dir: str, out_dir: str,
                            ext: str = 'wav') -> Tuple[List[str], List[str]]:
        print('Lookup file list...')
        in_wav_list = glob.glob(os.path.join(in_dir, '**', '*.' + ext), recursive=True)
        print('Start to make sub directories...')
        for d in {os.path.join(out_dir, get_sub_dir(in_dir, p)) for p in in_wav_list}:
            os.makedirs(d, exist_ok=True)
        out_wav_list = [os.path.join(out_dir, get_sub_paths(in_dir, p)) for p in in_wav_list]
        return in_wav_list, out_wav_list

    @staticmethod
    def preprocess_audio(in_dir: str, out_dir: str, sample_rate: int = 22050):
        """Normalize + resample every wav under ``in_dir`` into ``out_dir``."""
        in_wav_list, out_wav_list = Processor._get_wave_file_list(in_dir, out_dir)
        go_multiprocess(process_all, [(i, o, sample_rate) for i, o
                                      in zip(in_wav_list, out_wav_list)], Processor.num_workers)
        print('Processed {} files'.format(len(in_wav_list)))

    @staticmethod
    def resample_audio(in_dir: str, out_dir: str, sample_rate: int):
        """Resample every wav under ``in_dir`` into ``out_dir``."""
        in_wav_list, out_wav_list = Processor._get_wave_file_list(in_dir, out_dir)
        go_multiprocess(resample, [(i, o, sample_rate) for i, o
                                   in zip(in_wav_list, out_wav_list)], Processor.num_workers)

    @staticmethod
    def voice_bank(in_dir: str, out_dir: str, min_wav_rate: int = 0,
                   max_wav_rate: int = 9999, sample_rate: int = 22050):
        """VoiceBank: normalize audio, copy texts, emit meta files."""
        print('Start to process audio files!')
        Processor.preprocess_audio(in_dir, out_dir, sample_rate=sample_rate)
        print('Copy text files...')
        Processor.copy_txt(in_dir, out_dir)
        meta_dir = os.path.join(out_dir, 'meta')
        VoiceBankMeta(meta_dir).make_meta(out_dir, min_wav_rate, max_wav_rate, 0)
        print('All processes are finished.')

    @staticmethod
    def vctk(in_dir: str, out_dir: str, sample_rate: int = 22050):
        """VCTK: normalize audio into <spk>/wav, copy txt, emit meta."""
        print('lookup files...')
        wave_file_list = glob.glob(os.path.join(in_dir, '*', '*', '*.wav'))
        txt_file_list = glob.glob(os.path.join(in_dir, 'txt', '*', '*.txt'))

        print('Make out file list...')
        out_wav_list = [os.path.join(out_dir, p.split(os.sep)[-2], 'wav', p.split(os.sep)[-1])
                        for p in wave_file_list]
        out_txt_list = [os.path.join(out_dir, p.split(os.sep)[-2], 'txt', p.split(os.sep)[-1])
                        for p in txt_file_list]

        print('Make directories...')
        for d in {os.path.dirname(p) for p in out_wav_list + out_txt_list}:
            os.makedirs(d, exist_ok=True)

        print('Start Audio Processing ...')
        go_multiprocess(process_all, [(i, o, sample_rate) for i, o
                                      in zip(wave_file_list, out_wav_list)], Processor.num_workers)
        go_multiprocess(read_and_write, list(zip(txt_file_list, out_txt_list)),
                        Processor.num_workers)

        meta_dir = os.path.join(out_dir, 'meta')
        VCTKMeta(meta_dir).make_meta(out_dir, out_wav_list, out_txt_list)

    @staticmethod
    def ljspeech(in_dir: str, out_dir: str, meta_csv_path: str, sample_rate: int = 22050):
        """LJSpeech: normalize wavs + join metadata.csv, emit meta. The csv
        is read as pandas' ``read_csv(sep='|', header=None)`` reads it: '"'
        quotes, a missing field None."""
        print('lookup files ...')
        wav_file_list = glob.glob(os.path.join(in_dir, 'wavs', '*.wav'))
        with open(meta_csv_path, newline='', encoding='utf-8') as f:
            txt_info = [tuple((row + [None] * 3)[:3]) for row in csv.reader(f, delimiter='|')]
        txt_info = [tuple(v if v != '' else None for v in row) for row in txt_info]

        os.makedirs(os.path.join(out_dir, 'wavs'), exist_ok=True)
        out_dir = os.path.abspath(out_dir)
        out_wav_list = [os.path.join(out_dir, 'wavs', os.path.basename(p))
                        for p in wav_file_list]

        print('Start Audio Processing ...')
        go_multiprocess(process_all, [(i, o, sample_rate) for i, o
                                      in zip(wav_file_list, out_wav_list)], Processor.num_workers)

        meta_dir = os.path.join(out_dir, 'meta')
        LJSpeechMeta(meta_dir).make_meta(out_wav_list, txt_info)

    @staticmethod
    def dsd100(data_dir: str, out_dir: str, wav_subset_len: int = 44100 * 10):
        """DSD100: chunk mixture / vocals into npy shards and derive the
        backgrounds, under ``<out_dir>/<subset>/<song>/`` (the subset keeps a
        Dev and a Test song of one name apart)."""
        print('Lookup files ...')
        mixture_list = sorted(glob.glob(
            os.path.join(data_dir, 'Mixtures', '**', '**', 'mixture.wav')))
        vocals_list = sorted(glob.glob(
            os.path.join(data_dir, 'Sources', '**', '**', 'vocals.wav')))

        out_mixture_list, out_vocals_list, out_background_list = [], [], []
        for mixture_path in mixture_list:
            song_dir = os.path.dirname(mixture_path)
            subdir = os.path.join(os.path.basename(os.path.dirname(song_dir)),
                                  os.path.basename(song_dir))
            out_mixture_list.append(os.path.join(out_dir, subdir, 'mixture.npy'))
            out_vocals_list.append(os.path.join(out_dir, subdir, 'vocals.npy'))
            out_background_list.append(os.path.join(out_dir, subdir, 'background.npy'))

        print('Save as numpy files..')
        print('- Mixture File')
        go_multiprocess(load_split_numpy, [(i, o, wav_subset_len) for i, o
                                           in zip(mixture_list, out_mixture_list)],
                        Processor.num_workers)
        print('- Vocals File')
        go_multiprocess(load_split_numpy, [(i, o, wav_subset_len) for i, o
                                           in zip(vocals_list, out_vocals_list)],
                        Processor.num_workers)
        print('- Make Background Files')
        go_multiprocess(make_background_numpy,
                        [(m, v, o, wav_subset_len) for m, v, o
                         in zip(mixture_list, vocals_list, out_background_list)],
                        Processor.num_workers)

        meta_dir = os.path.join(out_dir, 'meta')
        DSD100Meta(meta_dir).make_meta(out_mixture_list, out_vocals_list, out_background_list)

    @staticmethod
    def extract_features(in_dir: str, out_dir: str, batch_size: int = 16,
                         pad_seconds: float = 10.0, sample_rate: int = 22050,
                         precision: str = 'bf16x3', wire: str = 'bf16',
                         h2d: str = 'i16_src', stages: int = 2,
                         device: str = 'cuda') -> Dict[str, Any]:
        """Log-mel features of every WAV under ``in_dir``: one
        ``<name>.mel.npy`` (80, n // 256 + 1) float32 in ``out_dir`` per
        utterance, n its length at ``sample_rate`` (cut at ``pad_seconds``).

        Files are grouped by source rate from their headers; each group's
        batches are (batch_size, pad_seconds * rate) matrices, resampled on
        the card by one fixed matrix per group. The host decodes a batch on
        a producer thread (the native runtime, GIL-free) while the card works
        on the one before, and the batch after that is written out:

        - ``stages`` 2: the main thread copies batch N to the card (pinned
          memory, a side stream) and starts its program, then waits for
          batch N-1's features and saves them;
        - ``stages`` 3: a third thread copies and starts the programs, so
          the copies to and from the card run at once.

        ``h2d`` is the audio wire: 'i16_src' (int16 at the source rate, the
        card resamples), 'i16_tgt' (the native runtime resamples on the host,
        int16 at ``sample_rate``) or 'mulaw8_tgt' (the same, mu-law-256
        bytes); ``wire`` the features' way back: 'bf16' (widened exactly to
        float32 on the host), 'f32' or 'int8' (per-row affine, within one
        step of range / 254). ``precision`` is K2's (its three modes all
        compute fp64, see ``fused_log_mel``).

        Deviations from the reference's resample-then-pad pipeline, kept
        from the JAX package: the last half-window's reflect context is
        mirrored at the source rate before the resample (:func:`reflect_tail`),
        and a file that fills ``pad_seconds`` gets none; the RMS gain counts
        that mirrored tail.

        ``device`` 'cuda' needs a card (a missing one raises); 'cpu' runs
        the same program with the log-mel kernel's plain version. Sharding
        a corpus over ranks waits for the multi-GPU port: with
        ``torch.distributed`` initialised over more than one rank this
        raises. Returns counts and timings: utterances and batches written,
        seconds from the first decode to the last save, and per batch the
        host decode, host staging, save ms and, on the card, the copies' and
        the program's device ms (CUDA events).
        """
        if wire not in WIRES or h2d not in H2D_WIRES:
            raise ValueError('wire is one of %s and h2d one of %s, got %r, %r'
                             % (WIRES, H2D_WIRES, wire, h2d))
        device = torch.device(device)
        if device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("extract_features on 'cuda' needs a CUDA device; "
                               "pass device='cpu' for the CPU path")
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError('extract_features over several ranks waits for the '
                                      'multi-GPU port')
        native.load_library()                 # builds it, or raises with the compiler's words

        wav_list = sorted(glob.glob(os.path.join(in_dir, '**', '*.wav'), recursive=True))
        os.makedirs(out_dir, exist_ok=True)
        groups = defaultdict(list)            # src_sr -> paths
        for path in wav_list:
            try:
                groups[wavio.read_wav_info(path)[0]].append(path)
            except (OSError, ValueError, struct.error):
                print('skipping unreadable {}'.format(path))
        host_resample = h2d != 'i16_src'
        on_card = device.type == 'cuda'
        copier = PinnedCopier(device) if on_card else None
        d2h_pool = PinnedPool() if on_card else None
        stats = defaultdict(list)
        written = 0
        t0 = time.perf_counter()

        for src_sr, paths in sorted(groups.items()):
            wire_sr = sample_rate if host_resample else src_sr
            pad_len = int(pad_seconds * wire_sr)
            print('extract_features: {} files at {} Hz'.format(len(paths), src_sr))
            host_q = queue.Queue(maxsize=2)   # decoded host batches
            failure = []

            def producer(_paths=paths, _src_sr=src_sr, _pad_len=pad_len):
                try:
                    for i in range(0, len(_paths), batch_size):
                        t = time.perf_counter()
                        item = decode_batch(_paths[i:i + batch_size], _src_sr, sample_rate,
                                            _pad_len, h2d)
                        stats['decode_ms'].append((time.perf_counter() - t) * 1e3)
                        host_q.put(item)
                except BaseException as e:     # raised again by the consumer
                    failure.append(e)
                finally:
                    host_q.put(None)           # always unblock the consumer

            def dispatch(item, _wire_sr=wire_sr):
                """H2D and the program of one batch; starts the D2H."""
                mat, lens, names = item
                t = time.perf_counter()
                lengths = np.asarray(lens, np.int64)
                if on_card:
                    pending = copier.put([mat, lengths])
                    x, lengths_dev = copier.take(pending)
                    stats['stage_ms'].append((time.perf_counter() - t) * 1e3)
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                else:
                    x, lengths_dev = torch.from_numpy(mat), torch.from_numpy(lengths)
                    pending = start = None
                outputs = feature_program(x, lengths_dev, _wire_sr, sample_rate, precision,
                                          wire)
                bufs, host, d2h_start, d2h_end = _to_host(outputs, d2h_pool)
                return dict(bufs=bufs, host=host, lens=lens, names=names, h2d=pending,
                            program=(start, d2h_start), d2h=(d2h_start, d2h_end))

            def write_out(done):
                t = time.perf_counter()
                if done['d2h'][1] is not None:
                    done['d2h'][1].synchronize()     # the features are on the host
                    h2d = done['h2d']
                    stats['h2d_ms'].append(h2d.start.elapsed_time(h2d.end))
                    stats['program_ms'].append(done['program'][0].elapsed_time(
                        done['program'][1]))
                    stats['d2h_ms'].append(done['d2h'][0].elapsed_time(done['d2h'][1]))
                mel = _mel_arrays(done['host'])
                for i, (n, name) in enumerate(zip(done['lens'], done['names'])):
                    # a contiguous copy: np.save writes a strided view through
                    # nditer chunks, ~5x slower, to the same bytes
                    np.save(os.path.join(out_dir, name + '.mel.npy'),
                            np.ascontiguousarray(mel[i, :, :n // settings.HOP_LENGTH + 1]))
                for buf in done['bufs']:
                    d2h_pool.give(buf)
                stats['save_ms'].append((time.perf_counter() - t) * 1e3)
                return len(done['names'])

            threading.Thread(target=producer, daemon=True).start()
            if stages >= 3:
                dev_q = queue.Queue(maxsize=2)       # dispatched batches

                def uploader():
                    drained = False
                    try:
                        with torch.cuda.device(device) if on_card else contextlib.nullcontext():
                            while True:
                                item = host_q.get()
                                if item is None:
                                    drained = True
                                    break
                                if item[0] is not None:
                                    dev_q.put(dispatch(item))
                    except BaseException as e:
                        failure.append(e)
                    finally:
                        if not drained:               # let the producer finish
                            _drain(host_q)
                        dev_q.put(None)              # always unblock the writer

                threading.Thread(target=uploader, daemon=True).start()
                while True:
                    done = dev_q.get()
                    if done is None:
                        break
                    written += write_out(done)
            else:
                pending, drained = None, False
                try:
                    while True:
                        item = host_q.get()
                        if item is None:
                            drained = True
                            break
                        out = dispatch(item) if item[0] is not None else None
                        if pending is not None:
                            written += write_out(pending)   # D2H + save of batch N-1
                        pending = out
                    if pending is not None:
                        written += write_out(pending)
                finally:
                    if not drained:
                        _drain(host_q)
            if failure:
                raise failure[0]

        stats = dict(stats, utterances=written, batches=len(stats['save_ms']),
                     seconds=time.perf_counter() - t0, device=str(device))
        print('Finished: {} utterances of {} files'.format(written, len(wav_list)))
        return stats


def _drain(q: queue.Queue):
    """Take items until the producer's closing None."""
    while q.get() is not None:
        pass


if __name__ == '__main__':
    from pytorch_sound_tpu_torch.utils.cli import fire_like
    fire_like(Processor)
