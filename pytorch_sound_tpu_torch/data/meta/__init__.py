"""Dataset meta frames: typed column descriptors over a small table.

The port's copy of ``pytorch_sound_tpu/data/meta/__init__.py``. A
:class:`MetaFrame` subclass declares typed columns and a ``make_meta``
pipeline that scans a raw dataset into all / train / val JSON files, and
drives :class:`~pytorch_sound_tpu_torch.data.dataset.SpeechDataset`.

The JAX package keeps metas in pandas frames. The port keeps them in
:class:`MetaTable`, a table of its own with the operations its callers use
(``table[col].values``, ``table.iloc[i][col]``, ``len``, boolean filtering,
``col in table``), and reads and writes the meta files as pandas does
(:func:`write_table_json`, :func:`read_table_json`), so that a meta written
by either package reads back to the same rows in the same order in both.
"""

import abc
import csv
import enum
import json
import math
import os
import re
from numbers import Integral, Real
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from pytorch_sound_tpu_torch.utils.commons import go_multiprocess
from pytorch_sound_tpu_torch.utils.sound import get_wav_duration


class Column(list):
    """One column's values in row order; ``.values`` is them as a numpy
    array (object dtype for text, as pandas gives)."""

    @property
    def values(self) -> np.ndarray:
        if any(isinstance(v, str) or v is None for v in self):
            out = np.empty(len(self), dtype=object)
            out[:] = list(self)
            return out
        return np.asarray(list(self))


class _ILoc:
    def __init__(self, table: 'MetaTable'):
        self._table = table

    def __getitem__(self, pos):
        """A row as a dict (column -> value) for an int; a table of the rows
        at a sequence of positions, in that order."""
        t = self._table
        if isinstance(pos, Integral):
            return {name: col[pos] for name, col in t._cols.items()}
        pos = [int(p) for p in pos]
        return MetaTable({name: [col[p] for p in pos] for name, col in t._cols.items()},
                         index=[t.index[p] for p in pos])


class MetaTable:
    """Columns of equal length keyed by name, and ordered row keys (the
    pandas index).

    ``MetaTable(columns)`` takes a dict of column -> list of values, or of
    column -> dict of row key -> value (as ``pd.DataFrame`` takes a dict of
    dicts: the row keys are the union of the inner keys in first-seen order,
    a missing cell is None). ``index`` defaults to 0 .. n - 1.
    """

    def __init__(self, columns: Optional[Dict[str, Any]] = None,
                 index: Optional[Sequence[Any]] = None):
        columns = dict(columns or {})
        if columns and all(isinstance(v, dict) for v in columns.values()):
            keys = list(dict.fromkeys(k for v in columns.values() for k in v))
            columns = {name: [v.get(k) for k in keys] for name, v in columns.items()}
            index = keys if index is None else index
        self._cols: Dict[str, Column] = {}
        n = len(next(iter(columns.values()))) if columns else len(index or [])
        self.index = list(range(n)) if index is None else list(index)
        for name, values in columns.items():
            self[name] = values

    def __len__(self) -> int:
        return len(self.index)

    def __contains__(self, name) -> bool:
        return name in self._cols

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __getitem__(self, key):
        """A column by name; or the rows where a boolean mask is True."""
        if isinstance(key, str):
            return self._cols[key]
        mask = [bool(m) for m in key]
        if len(mask) != len(self):
            raise ValueError('mask of %d for %d rows' % (len(mask), len(self)))
        return self.iloc[[i for i, m in enumerate(mask) if m]]

    def __setitem__(self, name: str, values):
        values = list(values.values if isinstance(values, Column) else values)
        if len(values) != len(self):
            raise ValueError('column %r has %d values for %d rows'
                             % (name, len(values), len(self)))
        self._cols[name] = Column(_py(v) for v in values)

    @property
    def iloc(self) -> _ILoc:
        return _ILoc(self)

    def sort_values(self, by: str) -> 'MetaTable':
        """Rows ascending in column ``by``, by numpy's quicksort as pandas'
        ``sort_values`` sorts: equal values keep no guaranteed order, and
        take the order pandas gives them."""
        return self.iloc[np.argsort(self[by].values, kind='quicksort')]


def _py(v):
    """numpy scalars as Python ones, so JSON and comparisons see plain types."""
    return v.item() if isinstance(v, np.generic) else v


# ---------------------------------------------------------------- JSON, as pandas

def _float_text(value: float) -> str:
    """A float as pandas' ``to_json`` writes it (its ujson encoder at
    ``double_precision=10``): fixed point rounded to 10 decimals, trailing
    zeros dropped, '%.10g' outside [1e-15, 1e16 - 1]."""
    if math.isnan(value) or math.isinf(value):
        return 'null'
    neg = value < 0
    value = -value if neg else value
    if value > 1e16 - 1 or (value != 0.0 and value < 1e-15):
        return '%.10g' % (-value if neg else value)
    whole = int(value)
    tmp = (value - whole) * 1e10
    frac = int(tmp)
    diff = tmp - frac
    if diff > 0.5 or (diff == 0.5 and (frac == 0 or frac & 1)):
        frac += 1
    if frac >= 10 ** 10:
        frac, whole = 0, whole + 1
    text = '%d.%s' % (whole, ('%010d' % frac).rstrip('0') or '0')
    return '-' + text if neg else text


def _value_text(v) -> str:
    if v is None:
        return 'null'
    if isinstance(v, (bool, np.bool_)):
        return 'true' if v else 'false'
    if isinstance(v, Integral):
        return str(int(v))
    if isinstance(v, Real):
        return _float_text(float(v))
    return json.dumps(str(v)).replace('/', '\\/')


def table_json(table: MetaTable) -> str:
    """The table in pandas' ``to_json`` default (columns) orientation, byte
    for byte: ``{"col":{"key":value,...},...}``, '/' escaped, non-ASCII as
    \\u escapes, floats as :func:`_float_text`."""
    keys = [_value_text(str(k)) for k in table.index]
    return '{%s}' % ','.join(
        '%s:{%s}' % (_value_text(name), ','.join(
            '%s:%s' % (k, _value_text(v)) for k, v in zip(keys, table[name])))
        for name in table.columns)


def write_table_json(table: MetaTable, path: str):
    with open(path, 'w', encoding='ascii') as f:
        f.write(table_json(table))


_POW10_NEG = [float('1e-%d' % k) for k in range(16)]


def _pandas_float(text: str) -> float:
    """A JSON number as pandas' ``read_json`` parses it (its ujson decoder,
    ``precise_float=False``): integer part, then at most 15 fraction digits
    accumulated as a double and scaled by 10^-digits. It differs from
    Python's correctly rounded ``float`` in the last bit on about one value
    in ten."""
    mantissa, _, exponent = text.lower().partition('e')
    neg = mantissa.startswith('-')
    whole, _, frac = mantissa.lstrip('-').partition('.')
    frac_value, digits = 0.0, 0
    for ch in frac[:15]:
        frac_value = frac_value * 10.0 + float(ord(ch) - 48)
        digits += 1
    value = (float(int(whole or '0')) + frac_value * _POW10_NEG[digits]) * (-1.0 if neg else 1.0)
    return value * 10.0 ** int(exponent) if exponent else value


def _convert_column(values: List[Any]) -> List[Any]:
    """pandas' dtype inference on read: a float column whose values are all
    integral becomes int, and so does a text column of integer strings."""
    present = [v for v in values if v is not None]
    if not present or any(isinstance(v, bool) for v in present):
        return values
    if all(isinstance(v, float) for v in present) and all(v == int(v) for v in present):
        return [None if v is None else int(v) for v in values]
    if all(isinstance(v, str) and re.fullmatch(r'\s*[-+]?\d+\s*', v) for v in present):
        return [None if v is None else int(v) for v in values]
    return values


def read_table_json(path: str) -> MetaTable:
    """A table written by :func:`write_table_json` or by pandas' ``to_json``
    (columns orientation), or a list of row objects (the columns in
    first-seen order, a missing cell None), read as ``pd.read_json`` reads
    it: numbers by its parser, its dtype inference, integer row keys where
    every key is one."""
    with open(path, encoding='utf-8') as f:
        raw = json.load(f, parse_float=_pandas_float)
    if isinstance(raw, list):                      # records: row keys 0 .. n - 1
        names = list(dict.fromkeys(k for row in raw for k in row))
        table = MetaTable({name: [row.get(name) for row in raw] for name in names},
                          index=range(len(raw)))
    else:
        table = MetaTable(raw)
    if all(isinstance(k, str) and re.fullmatch(r'-?\d+', k) for k in table.index):
        table.index = [int(k) for k in table.index]
    for name in table.columns:
        table[name] = _convert_column(list(table[name]))
    return table


def _csv_value(text: str, kind: type):
    if text == '':
        return None
    return kind(text) if kind is not str else text


def read_table_csv(path: str) -> MetaTable:
    """A CSV file with a header line, as ``pd.read_csv`` reads it for the
    kinds of columns a meta holds: a column of integers is int (float where
    a cell is empty), one of numbers float, anything else text; an empty
    cell None; row keys 0 .. n - 1."""
    with open(path, newline='', encoding='utf-8') as f:
        rows = list(csv.reader(f))
    header, body = rows[0], [r for r in rows[1:] if r]
    columns = {}
    for i, name in enumerate(header):
        cells = [r[i] if i < len(r) else '' for r in body]
        present = [c for c in cells if c != '']
        kind = str
        for candidate in (int, float):
            try:
                for c in present:
                    candidate(c)
            except ValueError:
                continue
            kind = candidate
            break
        if kind is int and len(present) < len(cells):
            kind = float
        columns[name] = [_csv_value(c, kind) for c in cells]
    return MetaTable(columns, index=range(len(body)))


# ---------------------------------------------------------------- meta frames

class MetaType(enum.Enum):
    AUDIO: int = 1
    SCALAR: int = 2
    MIDI: int = 3
    TEXT: int = 4
    META: int = 5


class MetaFrame:
    """Describes a dataset: typed columns + preprocessing into meta JSON files.

    Subclasses override :attr:`columns`, :attr:`meta`, and :meth:`make_meta`.
    """

    #: column types that yield per-sample arrays; META columns are
    #: bookkeeping only and never reach the dataset layer
    _DATA_TYPES = frozenset(
        (MetaType.AUDIO, MetaType.SCALAR, MetaType.MIDI, MetaType.TEXT))

    @property
    def process_columns(self) -> List[Tuple[MetaType, str]]:
        """The subset of :attr:`columns` that produce data points."""
        return [c for c in self.columns if c[0] in self._DATA_TYPES]

    @property
    @abc.abstractmethod
    def columns(self) -> List[Tuple[MetaType, str]]:
        raise NotImplementedError(
            '%s is missing its column declaration' % type(self).__name__)

    @property
    def column_names(self) -> List[str]:
        return [name for _, name in self.columns]

    @property
    @abc.abstractmethod
    def meta(self) -> MetaTable:
        raise NotImplementedError(
            '%s does not build a meta frame' % type(self).__name__)

    @abc.abstractmethod
    def make_meta(self, *args, **kwargs):
        raise NotImplementedError(
            '%s cannot scan a raw dataset into meta JSONs'
            % type(self).__name__)

    @property
    def iloc(self):
        return self.meta.iloc

    def _process_duration(self, wav_file_list: List[str], min_wav_rate: float,
                          max_wav_rate: float) -> List[float]:
        """AND duration bounds into the frame's ``pass`` column.

        Durations are probed by a worker pool; a probe failure reports -1
        and unconditionally fails the row. The (min, max) bound check only
        applies when both bounds are truthy.
        """
        durations = go_multiprocess(get_wav_duration,
                                    [(p,) for p in wav_file_list])

        def keeps(dur: float) -> bool:
            if dur == -1:
                return False
            if not (min_wav_rate and max_wav_rate):
                return True
            return min_wav_rate < dur < max_wav_rate

        self._meta['pass'] = [prev and keeps(d)
                              for prev, d in zip(self._meta['pass'], durations)]
        return durations

    def _process_txt(self, txt_file_list: List[str], dur_list: List[float],
                     min_txt_rate: float):
        """Clean each transcript and AND the chars-per-second gate into ``pass``."""
        jobs = [((path, min_txt_rate, dur),)
                for path, dur in zip(txt_file_list, dur_list)]
        cleaned = go_multiprocess(preprocess_text, jobs)
        self._meta['text'] = [text for text, _ in cleaned]
        self._meta['pass'] = [prev and ok for prev, (_, ok)
                              in zip(self._meta['pass'], cleaned)]

    @staticmethod
    def save_meta(frame_file_names: List[str], meta_path: str,
                  all_frame: MetaTable, train_frame: MetaTable,
                  val_frame: MetaTable):
        """Write the [all, train, val] frames as JSON files under
        ``meta_path``, in the bytes pandas' ``to_json`` writes
        (:func:`write_table_json`)."""
        if os.path.exists(meta_path) and not os.path.isdir(meta_path):
            raise NotADirectoryError(meta_path)
        os.makedirs(meta_path, exist_ok=True)
        for name, frame in zip(frame_file_names,
                               (all_frame, train_frame, val_frame)):
            write_table_json(frame, os.path.join(meta_path, name))


# character set kept by transcript cleanup: basic latin + common punctuation
_TXT_KEEP = re.compile(r"[a-zA-Z'\.,\?! ]+")


def preprocess_text(args: Tuple[str, float, float]) -> List:
    """Worker: read one transcript, strip non-English characters, gate on
    text-length / audio-duration ratio. Returns ``[cleaned_text, passed]``.

    A transcript that is missing (no path) or cannot be read or decoded, or
    a zero duration under a ratio gate, yields ``['', False]``: the row is dropped by the
    ``pass`` filter rather than aborting the scan.
    """
    path, min_ratio, duration = args
    try:
        with open(path, encoding='utf-8') as fh:
            raw = fh.read()
        text = ' '.join(piece.strip() for piece in _TXT_KEEP.findall(raw.strip()))
        if not min_ratio:
            return [text, True]
        n_chars = len(' '.join(text.split()))
        return [text, (n_chars / float(duration)) >= min_ratio]
    except (OSError, TypeError, UnicodeDecodeError, ZeroDivisionError):
        return ['', False]
