"""Speech dataset and loader driven by MetaFrame columns: the port's copy of
``pytorch_sound_tpu/data/dataset.py``.

- :class:`SpeechDataset` loads numpy samples per typed meta column.
- :class:`SpeechDataLoader` is an iterable of collated **numpy** batches, with
  a thread-pool prefetch in place of worker processes; batches are
  zero-padded per field, with an optional ``pad_multiple`` that rounds the
  time axis up. The trainer moves batches to the card through pinned
  memory (``parallel.prefetch_to_device``); ``pin_memory`` is accepted and
  ignored.

Random draws (crops, bucket shuffles and choices, shuffles) come from an
``np.random.RandomState`` given as ``rng``, by default the global numpy
stream the JAX package draws from. At ``num_workers=0`` the draws happen in
the JAX package's order, so after ``np.random.seed(s)`` both packages yield
the same batches, bit for bit. With workers, crops are drawn from worker
threads in an order that varies between runs, in both packages.

A loader can resume the epoch in progress: :meth:`SpeechDataLoader.state_dict`
holds the batches (or the bucket sampler's buckets) that come after the last
batch it yielded, whatever its worker threads have drawn ahead, and after
:meth:`~SpeechDataLoader.load_state_dict` the next iteration goes on from
there. With the numpy state restored beside it, as the trainer's checkpoints
do, a resumed run draws the batches and crops the uninterrupted run drew
(with workers, where the crops draw nothing from numpy: the threads' crops
come in an order that varies between runs).
"""

import math
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from pytorch_sound_tpu_torch.data.meta import MetaFrame, MetaType
from pytorch_sound_tpu_torch.utils.text import eng_t2i
from pytorch_sound_tpu_torch.utils.wavio import load_wav


class SpeechDataset:
    """Map-style dataset over a MetaFrame."""

    def __init__(self, meta_frame: MetaFrame, fix_len: int = 0, fix_shuffle: bool = False,
                 skip_audio: bool = False, audio_mask: bool = False,
                 extra_features: List[Tuple[str, Callable]] = None,
                 rng: Optional[np.random.RandomState] = None):
        """
        :param meta_frame: MetaFrame instance describing the data
        :param fix_len: random-crop audio columns to this many samples (0 = off)
        :param fix_shuffle: re-randomize the crop start per audio column
        :param skip_audio: drop AUDIO columns entirely
        :param audio_mask: append a ones-mask matching the first audio column
        :param extra_features: [(column_name, fn)] computed features appended last
        :param rng: the crops' random stream (default: the global numpy one)
        """
        self.meta_frame = meta_frame
        self.fix_len = fix_len
        self.fix_shuffle = fix_shuffle
        self.cols = self.meta_frame.process_columns
        self.audio_mask = audio_mask
        self.extra_features = extra_features
        self.rng = np.random if rng is None else rng

        if self.extra_features:
            column_names = [name for _, name in self.meta_frame.columns]
            unknown = [name for name, _ in extra_features if name not in column_names]
            if unknown:
                raise ValueError('Unmatched extra_feature name! {} {}'.format(
                    column_names, unknown))
            self.target_idx_map = {name: idx for idx, (_, name)
                                   in enumerate(self.meta_frame.process_columns)}

        if skip_audio:
            self.cols = [(t, name) for (t, name) in self.cols if t != MetaType.AUDIO]

    def __getitem__(self, idx: int) -> List:
        return self.handle_fields(self.meta_frame.iloc[idx])

    def handle_fields(self, meta_item) -> List:
        """Load one data point: per-column load + shared random crop + mask."""
        results = []
        mask = None
        start_idx = -1

        for type_, name in self.cols:
            if type_ == MetaType.AUDIO:
                item = self.load_audio(meta_item[name])
                if self.fix_len:
                    if start_idx == -1 or self.fix_shuffle:
                        start_idx = self.rng.randint(0, max(1, len(item) - self.fix_len + 1))
                    item = item[start_idx:start_idx + self.fix_len]
                if self.audio_mask and mask is None:
                    mask = np.ones_like(item)
            elif type_ == MetaType.MIDI:
                raise NotImplementedError(
                    'MIDI column {!r}: the MIDI reader comes with the maestro '
                    'recipe, which is not ported yet'.format(name))
            elif type_ == MetaType.SCALAR:
                item = int(meta_item[name])
            elif type_ == MetaType.TEXT:
                item = self.load_txt(meta_item[name])
            else:
                raise NotImplementedError('{} is not implemented !'.format(name))
            results.append(item)

        if self.extra_features:
            for name, func in self.extra_features:
                results.append(func(results[self.target_idx_map[name]]))

        if mask is not None:
            results.append(mask)
        return results

    def load_audio(self, file_path: str) -> np.ndarray:
        if file_path.endswith('.wav'):
            wav, sr = load_wav(file_path, sr=None)
            if sr != self.meta_frame.sr:
                raise ValueError('sample rate miss match.\n {}\t {} in {}'.format(
                    self.meta_frame.sr, sr, file_path))
        elif file_path.endswith('.npy'):
            wav = np.load(file_path)
        else:
            raise NotImplementedError(
                '{} : File Type is not implemented to load audio data !'.format(file_path))
        return wav

    @staticmethod
    def load_txt(txt: str) -> np.ndarray:
        return eng_t2i(txt)

    def __len__(self) -> int:
        return len(self.meta_frame)


class BucketRandomBatchSampler:
    """Split the (duration-sorted) index space into contiguous buckets; draw
    batches from a random bucket so batch lengths are similar."""

    def __init__(self, data_source, n_buckets: int, batch_size: int,
                 skip_last_bucket: bool = False,
                 rng: Optional[np.random.RandomState] = None):
        if n_buckets <= 0:
            raise ValueError('the num of buckets has to be a positive value.')
        if len(data_source) <= n_buckets * batch_size:
            raise ValueError('Data size is too small to use bucket sampler ! '
                             '{} rows for {} buckets of {}'.format(
                                 len(data_source), n_buckets, batch_size))
        self.n_buckets = n_buckets
        self.data_size = len(data_source)
        self.batch_size = batch_size
        self.bucket_size = int(math.ceil(self.data_size / self.n_buckets))
        self.bucket_size -= self.bucket_size % batch_size
        self.skip_last_bucket = skip_last_bucket
        self.rng = np.random if rng is None else rng
        self._live: List[List[int]] = []       # the epoch in progress
        self._resume: List[List[int]] = []

    @property
    def buckets(self):
        return [list(range(i * self.bucket_size, (i + 1) * self.bucket_size))
                for i in range(self.n_buckets - int(self.skip_last_bucket))]

    def __iter__(self):
        if self._resume:
            buckets, self._resume = self._resume, []
        else:
            buckets = self.buckets
            for idx in range(len(buckets)):
                self.rng.shuffle(buckets[idx])
        self._live = buckets
        while buckets:
            bucket_id = self.rng.choice(range(len(buckets)))
            ids = buckets[bucket_id][-self.batch_size:]
            buckets[bucket_id] = buckets[bucket_id][:-self.batch_size]
            if not buckets[bucket_id]:
                buckets.pop(bucket_id)
            yield ids

    def state_dict(self) -> Dict[str, Any]:
        """The buckets of the epoch in progress, less what was yielded."""
        return {'buckets': [list(b) for b in self._live]}

    def load_state_dict(self, state: Dict[str, Any]):
        """The next iteration goes on with these buckets (a new epoch if
        they are empty)."""
        self._resume = [[int(i) for i in b] for b in state['buckets']]

    def __len__(self):
        return self.bucket_size * self.n_buckets // self.batch_size


class SpeechDataLoader:
    """Iterable of zero-pad-collated numpy batches with threaded prefetch.

    The constructor takes the JAX loader's arguments; ``pin_memory`` is
    accepted and ignored (the consumer moves batches to the card).
    ``pad_multiple`` additionally rounds the trailing (time) axis of padded
    fields up to a multiple. ``rng`` is the shuffles' and the bucket
    sampler's random stream (default: the global numpy one).
    """

    def __init__(self, dataset: SpeechDataset, batch_size: int, num_workers: int = 0,
                 n_buckets: int = 10, is_bucket: bool = False, is_shuffle: bool = False,
                 skip_last_bucket: bool = False, pin_memory: bool = True,
                 drop_last: bool = False, pad_multiple: int = 1,
                 prefetch_batches: int = 2, rng: Optional[np.random.RandomState] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(0, num_workers)
        self.is_shuffle = is_shuffle
        self.drop_last = drop_last
        self.pad_multiple = pad_multiple
        self.prefetch_batches = max(1, prefetch_batches)
        self.rng = np.random if rng is None else rng
        self.batch_sampler = None
        self._live: List[List[int]] = []       # unbucketed: the epoch's batches left
        self._resume: List[List[int]] = []
        if is_bucket:
            self.batch_sampler = BucketRandomBatchSampler(
                dataset, n_buckets=n_buckets, batch_size=batch_size,
                skip_last_bucket=skip_last_bucket, rng=rng)
        self._position = self._live_state()     # after the last batch yielded

    def _batch_indices(self):
        if self.batch_sampler is not None:
            yield from self.batch_sampler
            return
        if self._resume:
            self._live, self._resume = self._resume, []
        else:
            idx = np.arange(len(self.dataset))
            if self.is_shuffle:
                self.rng.shuffle(idx)
            self._live = []
            for s in range(0, len(idx), self.batch_size):
                chunk = idx[s:s + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    break
                self._live.append([int(i) for i in chunk])
        while self._live:
            yield self._live.pop(0)

    def _live_state(self) -> Dict[str, Any]:
        """Where the batch index generator stands now."""
        if self.batch_sampler is not None:
            return self.batch_sampler.state_dict()
        return {'batches': [list(b) for b in self._live]}

    def state_dict(self) -> Dict[str, Any]:
        """What the epoch in progress has left after the last batch yielded
        (the batch index generator may stand further on, where worker
        threads load ahead)."""
        return self._position

    def load_state_dict(self, state: Dict[str, Any]):
        """The next iteration goes on with the epoch in ``state`` (a new
        epoch where it has nothing left)."""
        if self.batch_sampler is not None:
            self.batch_sampler.load_state_dict(state)
        else:
            self._resume = [[int(i) for i in b] for b in state['batches']]
        self._position = state

    def _load_batch(self, ids: List[int]) -> List[Any]:
        return self.pad_collate_fn([self.dataset[i] for i in ids],
                                   pad_multiple=self.pad_multiple)

    def __iter__(self):
        if self.num_workers <= 0:
            for ids in self._batch_indices():
                batch = self._load_batch(ids)
                self._position = self._live_state()
                yield batch
            return
        # pipelined: keep `prefetch_batches` batch-futures in flight, each
        # with the position the generator had right after drawing it
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = []
            it = self._batch_indices()
            for ids in it:
                pending.append((pool.submit(self._load_batch, ids), self._live_state()))
                if len(pending) == self.prefetch_batches:
                    break
            for ids in it:
                nxt = (pool.submit(self._load_batch, ids), self._live_state())
                future, self._position = pending.pop(0)
                yield future.result()
                pending.append(nxt)
            while pending:
                future, self._position = pending.pop(0)
                yield future.result()

    def __len__(self):
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    @staticmethod
    def pad_collate_fn(batch: List[Any], pad_multiple: int = 1) -> List[np.ndarray]:
        """Per-field collation: ints -> int64 vector, ragged arrays ->
        zero-padded stack (time axis rounded up to ``pad_multiple``)."""
        result = []
        for i in range(len(batch[0])):
            sub_batch = [x[i] for x in batch]
            first = sub_batch[0]
            if not isinstance(first, np.ndarray):
                if any(type(x) is not type(first) for x in sub_batch[1:]):
                    raise TypeError('field {} mixes types in one batch'.format(i))
                if isinstance(first, int):
                    result.append(np.asarray(sub_batch, dtype=np.int64))
                elif isinstance(first, float):
                    result.append(np.asarray(sub_batch, dtype=np.float64))
                else:
                    result.append(np.asarray(sub_batch))
            else:
                result.append(SpeechDataLoader._pad_zero(sub_batch, pad_multiple))
        return result

    @staticmethod
    def _pad_zero(sub_batch: List[np.ndarray], pad_multiple: int = 1) -> np.ndarray:
        dims = [b.shape for b in sub_batch]
        max_dims = [max(d[i] for d in dims) for i in range(len(dims[0]))]
        if pad_multiple > 1:
            # quantize the time axis. The full quantum applies to 1-D float
            # fields (raw audio); frame-rate features and int fields (text
            # ids) are far shorter per step, so their quantum is capped at 32
            is_audio = (np.issubdtype(sub_batch[0].dtype, np.floating)
                        and len(max_dims) == 1)
            quantum = pad_multiple if is_audio else min(pad_multiple, 32)
            max_dims[-1] = int(math.ceil(max_dims[-1] / quantum)) * quantum
        out = np.zeros((len(sub_batch), *max_dims), dtype=sub_batch[0].dtype)
        for i, b in enumerate(sub_batch):
            out[i][tuple(slice(0, s) for s in b.shape)] = b
        return out
