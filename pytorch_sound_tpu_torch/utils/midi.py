"""Minimal Standard MIDI File parser producing piano rolls: the port's copy
of ``pytorch_sound_tpu/utils/midi.py``. Parses format 0/1 SMF, resolves
tempo changes, and renders a (128, T) velocity-valued piano roll at a given
frame rate, the contract of ``pretty_midi.PrettyMIDI(path).get_piano_roll()``
(default fs = 100).
"""

import struct
from typing import List, NamedTuple

import numpy as np


class Note(NamedTuple):
    pitch: int
    velocity: int
    start: float   # seconds
    end: float     # seconds
    channel: int


def _read_varlen(data: bytes, pos: int):
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not b & 0x80:
            return value, pos


def _parse_track(data: bytes):
    """Yield (tick, status, payload) events from one MTrk chunk body."""
    pos = 0
    tick = 0
    running_status = 0
    while pos < len(data):
        delta, pos = _read_varlen(data, pos)
        tick += delta
        status = data[pos]
        if status & 0x80:
            pos += 1
            if status < 0xF0:
                running_status = status
        else:
            status = running_status
        if status == 0xFF:                       # meta event
            meta_type = data[pos]
            pos += 1
            length, pos = _read_varlen(data, pos)
            yield tick, 0xFF, (meta_type, data[pos:pos + length])
            pos += length
        elif status in (0xF0, 0xF7):             # sysex
            length, pos = _read_varlen(data, pos)
            pos += length
        else:
            kind = status & 0xF0
            n_data = 1 if kind in (0xC0, 0xD0) else 2
            yield tick, status, data[pos:pos + n_data]
            pos += n_data


class MidiFile:
    """Parsed MIDI file: tempo map + note list + piano-roll rendering."""

    def __init__(self, path: str):
        with open(path, 'rb') as f:
            raw = f.read()
        if raw[:4] != b'MThd':
            raise ValueError('{} is not a MIDI file'.format(path))
        header_len = struct.unpack('>I', raw[4:8])[0]
        fmt, n_tracks, division = struct.unpack('>HHH', raw[8:14])
        if division & 0x8000:
            raise NotImplementedError('SMPTE time division is not supported')
        self.ticks_per_beat = division

        pos = 8 + header_len
        tracks: List[list] = []
        for _ in range(n_tracks):
            if raw[pos:pos + 4] != b'MTrk':
                break
            length = struct.unpack('>I', raw[pos + 4:pos + 8])[0]
            body = raw[pos + 8:pos + 8 + length]
            tracks.append(list(_parse_track(body)))
            pos += 8 + length

        # tempo map: list of (tick, usec_per_beat), default 120 bpm
        tempo_events = [(0, 500000)]
        for track in tracks:
            for tick, status, payload in track:
                if status == 0xFF and payload[0] == 0x51:
                    usec = int.from_bytes(payload[1], 'big')
                    tempo_events.append((tick, usec))
        tempo_events.sort()
        self._tempo_events = tempo_events

        self.notes: List[Note] = []
        for track in tracks:
            active = {}   # (channel, pitch) -> (start_tick, velocity)
            for tick, status, payload in track:
                kind = status & 0xF0
                channel = status & 0x0F
                if kind == 0x90 and payload[1] > 0:       # note on
                    active[(channel, payload[0])] = (tick, payload[1])
                elif kind == 0x80 or (kind == 0x90 and payload[1] == 0):  # note off
                    key = (channel, payload[0])
                    if key in active:
                        start_tick, velocity = active.pop(key)
                        self.notes.append(Note(
                            pitch=payload[0], velocity=velocity,
                            start=self._tick_to_time(start_tick),
                            end=self._tick_to_time(tick), channel=channel))
        self.notes.sort(key=lambda n: n.start)

    def _tick_to_time(self, tick: int) -> float:
        """Integrate the tempo map up to ``tick``."""
        time = 0.0
        prev_tick, usec_per_beat = self._tempo_events[0]
        for ev_tick, ev_usec in self._tempo_events[1:]:
            if ev_tick >= tick:
                break
            time += (ev_tick - prev_tick) * usec_per_beat / (1e6 * self.ticks_per_beat)
            prev_tick, usec_per_beat = ev_tick, ev_usec
        time += (tick - prev_tick) * usec_per_beat / (1e6 * self.ticks_per_beat)
        return time

    def get_end_time(self) -> float:
        return max((n.end for n in self.notes), default=0.0)

    def remove_invalid_notes(self):
        self.notes = [n for n in self.notes if n.end > n.start]

    def get_piano_roll(self, fs: int = 100) -> np.ndarray:
        """Render a (128, T) velocity-valued piano roll at ``fs`` frames/sec."""
        end = self.get_end_time()
        n_frames = int(np.ceil(end * fs)) + 1
        roll = np.zeros((128, max(n_frames, 1)), dtype=np.float32)
        for n in self.notes:
            s, e = int(round(n.start * fs)), int(round(n.end * fs))
            roll[n.pitch, s:max(e, s + 1)] = n.velocity
        return roll
