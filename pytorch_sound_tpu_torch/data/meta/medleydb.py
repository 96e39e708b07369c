"""MedleyDB mix / vocal separation meta (https://github.com/marl/medleydb):
the port's copy of ``pytorch_sound_tpu/data/meta/medleydb.py`` — the stem
metadata files -> each song's vocal stems, several vocal stems summed into
one .npy a song, a train / val split stratified on the count of vocal
tracks.

The metadata files are YAML. The port reads them without PyYAML, with
:func:`parse_yaml`: a reader of the block-style subset that the published
MedleyDB metafiles use (nested mappings and sequences by indentation, plain,
single- and double-quoted scalars, the empty flow collections ``[]`` and
``{}``), resolving plain scalars as ``yaml.safe_load`` does (YAML 1.1: null,
booleans, ints, floats). It raises on anything outside that subset rather
than read it otherwise than PyYAML would.
"""

import glob
import json
import os
import re
from typing import Any, Dict, List, Tuple

import numpy as np

from pytorch_sound_tpu_torch.data.dataset import SpeechDataLoader
from pytorch_sound_tpu_torch.data.meta import MetaTable, MetaType
from pytorch_sound_tpu_torch.data.meta.base import SpeechMetaFrame, make_loaders
from pytorch_sound_tpu_torch.data.meta.commons import split_train_val_frame
from pytorch_sound_tpu_torch.utils.commons import go_multiprocess

MEDLEYDB_META_DIR = os.path.abspath(os.path.join(
    __file__, '..', '..', '..', '..', 'assets', 'medleydb_metafiles'))


class MedleyDBMeta(SpeechMetaFrame):

    default_sr = 44100
    sort_key = None

    @property
    def columns(self) -> List[Tuple[MetaType, str]]:
        return [(MetaType.AUDIO, 'mixture_filename'), (MetaType.AUDIO, 'voice_filename')]

    def make_meta(self, root_dir: str, meta_dir: str = None, filter_non_vocal: bool = True):
        if not meta_dir:
            meta_dir = MEDLEYDB_META_DIR

        print('Load MedleyDB meta info')
        meta = load_meta(meta_dir)
        meta_by_mixkey = {record['mix_filename'].replace('.wav', '.npy'): record
                          for record in meta}

        print('Lookup mix files')
        mix_file_list = [p.replace('.wav', '.npy')
                         for p in glob.glob(os.path.join(root_dir, '**', '**', '*.wav'))]

        print('Matching mix / vocal pairs')
        pair_meta = get_mix_vocal_pairs(mix_file_list, meta_by_mixkey, ext='npy')
        if filter_non_vocal:
            pair_meta = {k: v for k, v in pair_meta.items() if v}

        # multi-vocal songs get their tracks summed into one npy for fast loading
        mix_paths = list(pair_meta.keys())
        print('Merging multi-vocal-tracks ...')
        results = go_multiprocess(load_and_merge_audios, list(pair_meta.items()))

        rows = [(m, r[0], r[1]) for m, r in zip(mix_paths, results) if r != -1]
        mix_results, voice_results, source_numbers = map(list, zip(*rows))
        self._meta = MetaTable({'mixture_filename': mix_results,
                                'voice_filename': voice_results,
                                'voice_tracks': [min(s, 2) for s in source_numbers]})

        print('Make train / val meta')
        train_meta, val_meta = split_train_val_frame(
            self._meta, val_rate=0.1, label_key='voice_tracks')
        self.finalize_and_save(train_meta, val_meta)
        print('Done')


def load_and_merge_audios(mix_path: str, audio_npy_list: List[str]):
    """Merge a song's vocal-track npys into one '<stem>voice.npy'.

    Returns (out_path, n_tracks), or -1 where a file cannot be read or
    written (the row is dropped)."""
    try:
        if len(audio_npy_list) == 0:
            out_path = mix_path.replace('MIX.npy', '_voice.npy')
            np.save(out_path, np.zeros_like(np.load(mix_path)))
        elif len(audio_npy_list) == 1:
            out_path = audio_npy_list[0][:-6] + 'voice.npy'
            np.save(out_path, np.load(audio_npy_list[0]))
        else:
            out_path = audio_npy_list[0][:-6] + 'voice.npy'
            audios = [np.load(p)[np.newaxis, ...] for p in audio_npy_list]
            np.save(out_path, np.sum(audios, axis=0))
    except (OSError, ValueError):
        return -1
    return out_path, len(audio_npy_list)


# ---------------------------------------------------------------- the YAML subset

_INT = re.compile(r'[-+]?(0b[01_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)$')
_SEXAGESIMAL = re.compile(r'[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?$')
_FLOAT = re.compile(r'([-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?|\.[0-9_]+([eE][-+][0-9]+)?'
                    r'|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN))$')
_TIMESTAMP = re.compile(r'[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}')
_BOOL = {'yes': True, 'true': True, 'on': True, 'no': False, 'false': False, 'off': False}
# indent, '- ' (a sequence item), 'key:' (plain or quoted key), the rest
_LINE = re.compile(r'( *)(?:(- )|-$|([^\'"\[{#&*!|>%@`\s][^:#]*?|\'[^\']*\'|"[^"]*")'
                   r':(?: |$))?(.*)$')


def _int(text: str) -> int:
    digits = text.replace('_', '')
    sign = -1 if digits.startswith('-') else 1
    digits = digits.lstrip('+-')
    if digits.startswith('0b'):
        return sign * int(digits[2:], 2)
    if digits.startswith('0x'):
        return sign * int(digits[2:], 16)
    if len(digits) > 1 and digits.startswith('0'):
        return sign * int(digits, 8)
    return sign * int(digits)


def _plain(text: str) -> Any:
    """A plain scalar as YAML 1.1's resolver in ``yaml.safe_load`` reads it."""
    if text in ('', '~', 'null', 'Null', 'NULL'):
        return None
    if text.lower() in _BOOL and text in (text.lower(), text.capitalize(), text.upper()):
        return _BOOL[text.lower()]
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        body = text.replace('_', '').lower()
        if body.lstrip('+-') == '.inf':
            return float('-inf') if body.startswith('-') else float('inf')
        return float('nan') if body == '.nan' else float(body)
    if (_SEXAGESIMAL.match(text) or _TIMESTAMP.match(text) or text in ('=', '<<')
            or text[0] in '\'"[]{}#&*!|>%@`' or ': ' in text or ' #' in text):
        raise ValueError('YAML outside the reader\'s subset: %r' % text)
    return text


def _scalar(text: str) -> Any:
    text = text.strip()
    if text.startswith("'"):
        if not (len(text) > 1 and text.endswith("'")):
            raise ValueError('unterminated single-quoted scalar: %r' % text)
        return text[1:-1].replace("''", "'")
    if text.startswith('"'):
        return json.loads(text)
    if text in ('[]', '{}'):
        return [] if text == '[]' else {}
    return _plain(text)


def parse_yaml(text: str) -> Any:
    """One YAML document of the block-style subset described above, as
    ``yaml.safe_load`` reads it."""
    lines = []
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith('#') or raw.strip() == '---':
            continue
        if '\t' in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError('tab in indentation: %r' % raw)
        m = _LINE.match(raw)
        indent, dash, key, rest = len(m.group(1)), m.group(2), m.group(3), m.group(4)
        if raw.strip() == '-':
            dash, rest = '- ', ''
        lines.append((indent, dash is not None, key, rest))

    pos = 0

    def block(indent: int) -> Any:
        nonlocal pos
        first_indent, is_seq, _, _ = lines[pos]
        if is_seq:
            out = []
            while pos < len(lines) and lines[pos][0] == first_indent and lines[pos][1]:
                rest = lines[pos][3]
                pos += 1
                if rest.strip():
                    if _LINE.match(rest).group(3) is not None or rest.startswith('- '):
                        raise ValueError('compact nested collection: %r' % rest)
                    out.append(_scalar(rest))
                else:
                    out.append(nested(first_indent, in_seq=True))
            return out
        out = {}
        while pos < len(lines) and lines[pos][0] == first_indent and not lines[pos][1]:
            _, _, key, rest = lines[pos]
            if key is None:
                raise ValueError('expected "key:" at indent %d: %r' % (first_indent, rest))
            pos += 1
            key = _scalar(key)
            out[key] = _scalar(rest) if rest.strip() else nested(first_indent)
        return out

    def nested(parent: int, in_seq: bool = False) -> Any:
        """The block under a 'key:' (a sequence may sit at the key's indent)
        or under a bare '-'; None where there is none."""
        if pos >= len(lines):
            return None
        indent, is_seq = lines[pos][0], lines[pos][1]
        if indent > parent or (indent == parent and is_seq and not in_seq):
            return block(indent)
        return None

    if not lines:
        return None
    if len(lines) == 1 and lines[0][2] is None and not lines[0][1]:
        return _scalar(lines[0][3])
    value = block(lines[0][0])
    if pos != len(lines):
        raise ValueError('unexpected indentation at line: %r' % (lines[pos],))
    return value


def load_meta(dir_path: str) -> List[dict]:
    """Load every YAML metafile in a directory (non-YAML files skipped), in
    name order."""
    meta_list = []
    for file_name in sorted(os.listdir(dir_path)):
        if not file_name.endswith(('.yaml', '.yml')):
            continue
        with open(os.path.join(dir_path, file_name), 'r', encoding='utf-8') as r:
            meta_list.append(parse_yaml(r.read()))
    return meta_list


def get_mix_vocal_pairs(mix_file_list: List[str], meta_by_mixkey: Dict[str, dict],
                        ext: str = None) -> Dict[str, List[str]]:
    """Map each mixture file to the stem files whose instrument contains
    'singer' or 'vocal'."""
    if ext:
        ext = ext if ext.startswith('.') else '.' + ext

    def is_vocal(inst) -> bool:
        return 'singer' in inst or 'vocal' in inst

    vocal_files: Dict[str, List[str]] = {}
    for mix_file_name in mix_file_list:
        key = os.path.basename(mix_file_name)
        audio_dir = os.path.dirname(mix_file_name)
        stem_dir = os.path.join(audio_dir, os.path.basename(audio_dir) + '_STEMS')
        meta = meta_by_mixkey[key]
        vocal_files[mix_file_name] = []
        for val in meta['stems'].values():
            insts = val['instrument'] if isinstance(val['instrument'], list) \
                else [val['instrument']]
            if any(is_vocal(i) for i in insts):
                file_path = val['filename'] if not ext \
                    else val['filename'].replace('.wav', ext)
                vocal_files[mix_file_name].append(os.path.join(stem_dir, file_path))
    return vocal_files


def get_datasets(meta_dir: str, batch_size: int, num_workers: int,
                 fix_len: int = 0, audio_mask: bool = False,
                 pad_multiple: int = 1) -> Tuple[SpeechDataLoader, SpeechDataLoader]:
    return make_loaders(
        MedleyDBMeta, meta_dir, batch_size, num_workers,
        dataset_kwargs=dict(fix_len=fix_len, audio_mask=audio_mask),
        train_loader_kwargs=dict(is_bucket=False),
        valid_loader_kwargs=dict(is_bucket=False),
        pad_multiple=pad_multiple)


if __name__ == '__main__':
    import sys
    input_dir = sys.argv[1]
    MedleyDBMeta(os.path.join(input_dir, 'meta')).make_meta(input_dir)
