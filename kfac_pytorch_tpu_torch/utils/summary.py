"""TensorBoard scalar export without a dependency (the port's own stdlib
copy of ``kfac_pytorch_tpu/utils/summary.py``).

Event files are written directly in the TFRecord + Event-proto wire
format, hand-encoded, so no ``tensorboard`` import is needed and the
files load in stock TensorBoard.

Wire format (both are stable public formats):
  record  = len(u64 LE) | masked_crc32c(len) | payload | masked_crc32c(payload)
  Event   = 1: wall_time (double) | 2: step (varint int64)
          | 3: file_version (string, first record only) | 5: Summary
  Summary = 1: repeated Value;  Value = 1: tag (string) | 2: simple_value
"""

import os
import socket
import struct
import time


def _crc32c_table():
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _crc32c_table()


def _crc32c(data):
    c = 0xFFFFFFFF
    for b in data:
        c = _TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data):
    c = _crc32c(data)
    return ((((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


def _varint(n):
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num, wire, payload):
    return _varint((num << 3) | wire) + payload


def _len_delim(num, payload):
    return _field(num, 2, _varint(len(payload)) + payload)


def _event(wall_time, step=None, file_version=None, tag=None, value=None):
    msg = _field(1, 1, struct.pack('<d', wall_time))
    if step is not None:
        msg += _field(2, 0, _varint(step))
    if file_version is not None:
        msg += _len_delim(3, file_version.encode())
    if tag is not None:
        val = _len_delim(1, tag.encode()) + _field(
            2, 5, struct.pack('<f', float(value)))
        msg += _len_delim(5, _len_delim(1, val))
    return msg


class SummaryWriter:
    """Minimal scalar-only TensorBoard writer (``add_scalar``, ``flush``,
    ``close``, as ``torch.utils.tensorboard``'s); construct it on rank 0
    only."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        fname = (f'events.out.tfevents.{int(time.time())}.'
                 f'{socket.gethostname()}.{os.getpid()}')
        self._f = open(os.path.join(log_dir, fname), 'wb')
        self._write(_event(time.time(), file_version='brain.Event:2'))

    def _write(self, payload):
        header = struct.pack('<Q', len(payload))
        self._f.write(header + struct.pack('<I', _masked_crc(header))
                      + payload + struct.pack('<I', _masked_crc(payload)))

    def add_scalar(self, tag, value, step):
        self._write(_event(time.time(), step=int(step), tag=tag,
                           value=value))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def maybe_writer(tb_dir):
    """A writer to ``tb_dir`` on rank 0 (``utils.runlog.process_index``),
    else None."""
    from kfac_pytorch_tpu_torch.utils.runlog import process_index
    if tb_dir and process_index() == 0:
        return SummaryWriter(tb_dir)
    return None


def _read_varint(buf, i):
    n = shift = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _walk_fields(buf):
    """Yield (field_number, wire_type, value) over one proto message.
    value is: varint int (wire 0), 8-byte bytes (wire 1), payload bytes
    (wire 2), 4-byte bytes (wire 5)."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 0x7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:  # pragma: no cover — the writer never emits groups
            raise ValueError(f'unsupported wire type {wire}')
        yield num, wire, v


def read_scalars(log_dir):
    """Read every scalar series from the event files under ``log_dir`` —
    the inverse of :class:`SummaryWriter` (same hand-decoded TFRecord +
    Event wire format, so the round trip needs no tensorboard install;
    also loads files written by stock writers as long as they carry
    simple_value summaries). Returns ``{tag: [(step, value), ...]}``
    in file order; multiple event files are read in filename order."""
    series = {}
    names = sorted(f for f in os.listdir(log_dir)
                   if f.startswith('events.out.tfevents'))
    for name in names:
        with open(os.path.join(log_dir, name), 'rb') as f:
            data = f.read()
        i = 0
        while i + 12 <= len(data):
            (ln,) = struct.unpack('<Q', data[i:i + 8])
            if i + 12 + ln + 4 > len(data):
                break  # truncated tail (live writer / killed run) — skip
            payload = data[i + 12:i + 12 + ln]
            i += 12 + ln + 4  # len + len-crc + payload + payload-crc
            step = 0
            for num, wire, v in _walk_fields(payload):
                if num == 2 and wire == 0:
                    step = v
                elif num == 5 and wire == 2:      # Summary
                    for n2, w2, val_msg in _walk_fields(v):
                        if n2 != 1 or w2 != 2:
                            continue
                        tag, value = None, None
                        for n3, w3, v3 in _walk_fields(val_msg):
                            if n3 == 1 and w3 == 2:
                                tag = v3.decode()
                            elif n3 == 2 and w3 == 5:
                                (value,) = struct.unpack('<f', v3)
                        if tag is not None and value is not None:
                            series.setdefault(tag, []).append(
                                (step, value))
    return series


def log_epoch_scalars(tb, epoch, train_loss, lr, val_loss, val_acc):
    """The trainers' shared per-epoch scalar set. ``tb`` may be None.
    Callers must pass already-synced metric values — Metric.sync() is a
    cross-process collective and must run on every rank, never inside a
    rank-0-only branch."""
    if tb is None:
        return
    tb.add_scalar('train/loss', train_loss, epoch)
    tb.add_scalar('train/lr', lr, epoch)
    tb.add_scalar('val/loss', val_loss, epoch)
    tb.add_scalar('val/accuracy', val_acc, epoch)
    tb.flush()
