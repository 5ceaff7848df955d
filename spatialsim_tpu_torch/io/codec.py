"""Frame codec: npz staging + zstd/int16-delta packed frames.

Byte-compatible with the reference codec (``tools/record.py:88-279``):

* Staged frames are plain ``np.savez`` archives with float32 ``positions``
  and ``colors`` — the ~4 ms fast path during recording.
* Packed frames are a small container::

      u8   format        (1 = absolute float32, 2 = int16 delta x1000)
      u32  len(pos_blob) ; pos_blob = zstd(payload)
      u32  len(col_blob) ; col_blob = zstd(payload)

  Format 2 stores ``round((cur - prev) * 1000)`` as int16 — ≤ 5e-4 absolute
  quantization error per step, chosen by the reference for smooth motion.
* Delta chains terminate at the nearest format-1 base frame; decoding an
  arbitrary frame walks backward to a base then replays forward
  (iteratively — the reference's recursion-free design,
  ``tools/record.py:99-210``).
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

try:
    import zstandard as zstd
    HAVE_ZSTD = True
except ImportError:  # pragma: no cover - zstd is in the image
    zstd = None
    HAVE_ZSTD = False

FORMAT_ABSOLUTE = 1
FORMAT_DELTA = 2
DELTA_SCALE = 1000.0
# zstd level 19 like the reference; the background thread hides the cost.
ZSTD_LEVEL = 19


def frame_npz(rec_dir: Path, idx: int) -> Path:
    return Path(rec_dir) / f"frame_{idx:04d}.npz"


def frame_zstd(rec_dir: Path, idx: int) -> Path:
    return Path(rec_dir) / f"frame_{idx:04d}.zstd"


def save_frame(rec_dir: Path, frame_idx: int, positions: np.ndarray,
               colors: np.ndarray) -> None:
    """Stage one frame uncompressed (the recording-loop fast path)."""
    np.savez(frame_npz(rec_dir, frame_idx),
             positions=np.asarray(positions, np.float32),
             colors=np.asarray(colors, np.float32))


def compress_frame(positions: np.ndarray, colors: np.ndarray,
                   prev_positions: Optional[np.ndarray] = None,
                   prev_colors: Optional[np.ndarray] = None) -> bytes:
    """Pack one frame; delta vs the previous frame when available.

    If any per-element delta would saturate int16 (per-step motion beyond
    32.767 units — fast explosion presets can hit this), the frame falls
    back to an absolute (format-1) frame: a saturated delta would corrupt
    this frame AND the rest of its batch chain silently.
    """
    use_delta = prev_positions is not None and prev_colors is not None
    if use_delta:
        from spatialsim_tpu_torch.io import _native
        # Round-to-nearest (the reference truncates, tools/record.py:259;
        # rounding halves the quantization error and decodes identically).
        # The quantize loop runs in the native codec core when available.
        pos_delta, pos_sat = _native.delta_encode(
            positions, prev_positions, DELTA_SCALE)
        col_delta, col_sat = _native.delta_encode(
            colors, prev_colors, DELTA_SCALE)
        if pos_sat or col_sat:
            use_delta = False
    if use_delta:
        fmt = FORMAT_DELTA
        pos_payload = pos_delta.tobytes()
        col_payload = col_delta.tobytes()
    else:
        fmt = FORMAT_ABSOLUTE
        pos_payload = np.asarray(positions, np.float32).tobytes()
        col_payload = np.asarray(colors, np.float32).tobytes()

    c = zstd.ZstdCompressor(level=ZSTD_LEVEL, threads=1)
    pos_blob = c.compress(pos_payload)
    col_blob = c.compress(col_payload)
    return b"".join([
        struct.pack("B", fmt),
        struct.pack("I", len(pos_blob)), pos_blob,
        struct.pack("I", len(col_blob)), col_blob,
    ])


def peek_format(data: bytes) -> int:
    if not data:
        raise ValueError("empty frame container")
    return data[0]


def decompress_frame(data: bytes,
                     prev_positions: Optional[np.ndarray] = None,
                     prev_colors: Optional[np.ndarray] = None,
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Unpack one frame container; needs the previous frame for format 2."""
    fmt = peek_format(data)
    off = 1
    (pos_len,) = struct.unpack_from("I", data, off)
    off += 4
    pos_blob = data[off:off + pos_len]
    off += pos_len
    (col_len,) = struct.unpack_from("I", data, off)
    off += 4
    col_blob = data[off:off + col_len]

    d = zstd.ZstdDecompressor()
    pos_payload = d.decompress(pos_blob)
    col_payload = d.decompress(col_blob)

    if fmt == FORMAT_ABSOLUTE:
        positions = np.frombuffer(pos_payload, np.float32).reshape(-1, 3)
        colors = np.frombuffer(col_payload, np.float32).reshape(-1, 3)
        return positions.copy(), colors.copy()
    if fmt != FORMAT_DELTA:
        raise ValueError(f"unknown frame format {fmt}")
    if prev_positions is None or prev_colors is None:
        raise ValueError("delta frame requires the previous frame")
    from spatialsim_tpu_torch.io import _native
    pos_delta = np.frombuffer(pos_payload, np.int16).reshape(-1, 3)
    col_delta = np.frombuffer(col_payload, np.int16).reshape(-1, 3)
    positions = _native.delta_decode(pos_delta, prev_positions,
                                     1.0 / DELTA_SCALE)
    colors = _native.delta_decode(col_delta, prev_colors, 1.0 / DELTA_SCALE)
    return positions, colors


def load_frame(rec_dir: Path, frame_idx: int,
               prev_positions: Optional[np.ndarray] = None,
               prev_colors: Optional[np.ndarray] = None,
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Load a frame, resolving delta chains iteratively.

    If the frame is delta-packed and no previous frame is supplied, walk
    backward to the nearest base (format-1 .zstd, or a staged .npz), then
    replay deltas forward — bounded by the compressor's batch size, since
    every batch starts with a base frame.
    """
    rec_dir = Path(rec_dir)
    z = frame_zstd(rec_dir, frame_idx)
    npz = frame_npz(rec_dir, frame_idx)

    if not z.exists():
        if npz.exists():
            with np.load(npz) as f:
                return f["positions"].copy(), f["colors"].copy()
        raise FileNotFoundError(f"frame {frame_idx:04d} not found in {rec_dir}")

    data = z.read_bytes()
    if peek_format(data) == FORMAT_DELTA and (
            prev_positions is None or prev_colors is None):
        if frame_idx == 0:
            raise ValueError("frame 0 is delta-packed with no base")
        # Walk back to a base, collecting the chain.
        chain = []  # packed bytes, newest-first
        idx = frame_idx - 1
        base = None
        while idx >= 0:
            zi = frame_zstd(rec_dir, idx)
            ni = frame_npz(rec_dir, idx)
            if zi.exists():
                blob = zi.read_bytes()
                if peek_format(blob) == FORMAT_ABSOLUTE:
                    base = decompress_frame(blob)
                    break
                chain.append(blob)
                idx -= 1
            elif ni.exists():
                with np.load(ni) as f:
                    base = (f["positions"].copy(), f["colors"].copy())
                break
            else:
                raise FileNotFoundError(
                    f"frame {idx:04d} missing from delta chain in {rec_dir}")
        if base is None:
            raise ValueError(f"no base frame under delta frame {frame_idx}")
        prev_positions, prev_colors = base
        for blob in reversed(chain):
            prev_positions, prev_colors = decompress_frame(
                blob, prev_positions, prev_colors)

    return decompress_frame(data, prev_positions, prev_colors)
