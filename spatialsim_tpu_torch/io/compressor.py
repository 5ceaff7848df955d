"""Background batch compressor.

Host-side analogue of the reference's ``BackgroundCompressor``
(``tools/record.py:329-556``): a worker thread drains a queue of 50-frame
batches, re-packs each staged ``.npz`` into the zstd container (first frame
of every batch is an absolute base, the rest int16 deltas — bounding every
delta chain to one batch) and deletes the staged file.  Compression
failures keep the staged frame (reference ``:486-490``) so data is never
lost.  This is the reference's record→compress pipeline-parallelism
analogue (SURVEY.md §2): the device steps ahead while the host encodes.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from spatialsim_tpu_torch.io import codec

COMPRESSION_BATCH_SIZE = 50


class BackgroundCompressor:
    """Compresses finished frame batches on a daemon thread."""

    def __init__(self, rec_dir: Path, batch_size: int = COMPRESSION_BATCH_SIZE):
        self.rec_dir = Path(rec_dir)
        self.batch_size = batch_size
        self._queue: "queue.Queue[Optional[tuple]]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._queued_through = 0      # frames handed to the worker so far
        self.compressed_count = 0
        self.total_original_bytes = 0
        self.total_saved_bytes = 0
        self.failures = 0
        self.comp_times: list = []

    # -- producer side -----------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="frame-compressor")
        self._thread.start()

    def check_and_queue(self, frame: int) -> None:
        """Queue a batch whenever a full one has been staged."""
        done = frame + 1
        while done - self._queued_through >= self.batch_size:
            start = self._queued_through
            self._queue.put((start, start + self.batch_size))
            self._queued_through = start + self.batch_size

    def compress_remaining(self, total_frames: int) -> None:
        """Queue the final partial batch and wait for the queue to drain."""
        if total_frames > self._queued_through:
            self._queue.put((self._queued_through, total_frames))
            self._queued_through = total_frames
        self._queue.join()

    def stop(self) -> None:
        self._queue.put(None)
        if self._thread is not None:
            self._thread.join(timeout=60)

    # -- worker side -------------------------------------------------------
    def _worker(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                self._queue.task_done()
                return
            start, end = item
            try:
                self._compress_batch(start, end)
            finally:
                self._queue.task_done()

    def _compress_batch(self, start: int, end: int) -> None:
        prev_pos = prev_col = None
        for idx in range(start, end):
            npz = codec.frame_npz(self.rec_dir, idx)
            if not npz.exists():
                if codec.frame_zstd(self.rec_dir, idx).exists():
                    # Already packed (resume overlap); restart the chain.
                    prev_pos = prev_col = None
                    continue
                break
            t0 = time.time()
            try:
                with np.load(npz) as f:
                    pos = f["positions"].copy()
                    col = f["colors"].copy()
                # Chain head (batch start) is always an absolute base.
                use_prev = idx != start
                blob = codec.compress_frame(
                    pos, col,
                    prev_pos if use_prev else None,
                    prev_col if use_prev else None)
                codec.frame_zstd(self.rec_dir, idx).write_bytes(blob)
                original = npz.stat().st_size
                npz.unlink()
                with self._lock:
                    self.compressed_count += 1
                    self.total_original_bytes += original
                    self.total_saved_bytes += len(blob)
                    self.comp_times.append(time.time() - t0)
                    del self.comp_times[:-100]
                # The *decoded* previous frame is the delta baseline, so
                # decode drift matches encode drift (int16 quantization).
                if use_prev:
                    prev_pos, prev_col = codec.decompress_frame(
                        blob, prev_pos, prev_col)
                else:
                    prev_pos, prev_col = pos, col
            except Exception as exc:  # keep the staged frame on failure
                with self._lock:
                    self.failures += 1
                print(f"[Compress] frame {idx:04d} failed ({exc}); "
                      "keeping staged npz")
                prev_pos = prev_col = None

    # -- stats -------------------------------------------------------------
    def get_compressed_count(self) -> int:
        with self._lock:
            return self.compressed_count

    def stats(self) -> dict:
        with self._lock:
            ratio = (1.0 - self.total_saved_bytes
                     / max(1, self.total_original_bytes))
            avg = (sum(self.comp_times) / len(self.comp_times)
                   if self.comp_times else 0.0)
            return {"compressed": self.compressed_count,
                    "ratio": ratio, "avg_time": avg,
                    "failures": self.failures}
