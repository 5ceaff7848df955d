"""Recording session layout, metadata, checkpoint/resume.

Same on-disk contract as the reference (``tools/record.py:40-85,864-876``):
``recordings/<session>/`` holds ``metadata.json``, staged/packed frames and
rolling ``state_%04d.npz`` checkpoints (positions+velocities) every
``STATE_INTERVAL`` frames, older checkpoints deleted.  Frames hold only
positions+colors, so resuming *requires* a state file; without one the
recorder restarts from frame 0 (reference ``:724-735``).
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

STATE_INTERVAL = 50


def recordings_root() -> Path:
    """Base directory for sessions; override with SPATIALSIM_RECORDINGS."""
    return Path(os.environ.get("SPATIALSIM_RECORDINGS", "recordings"))


def get_recording_dir(session_name: str, create: bool = True) -> Path:
    d = recordings_root() / session_name
    if create:
        d.mkdir(parents=True, exist_ok=True)
    return d


def save_metadata(rec_dir: Path, config: dict,
                  start_time: Optional[float] = None) -> None:
    start_time = time.time() if start_time is None else start_time
    meta = {**config, "start_time": start_time,
            "start_datetime": datetime.fromtimestamp(start_time).isoformat()}
    (Path(rec_dir) / "metadata.json").write_text(json.dumps(meta, indent=2))


def load_metadata(rec_dir: Path) -> dict:
    return json.loads((Path(rec_dir) / "metadata.json").read_text())


def get_completed_frames(rec_dir: Path) -> int:
    """Count of contiguous frames from 0 (staged or packed)."""
    rec_dir = Path(rec_dir)
    count = 0
    while ((rec_dir / f"frame_{count:04d}.npz").exists()
           or (rec_dir / f"frame_{count:04d}.zstd").exists()):
        count += 1
    return count


def state_path(rec_dir: Path, frame: int) -> Path:
    return Path(rec_dir) / f"state_{frame:04d}.npz"


def find_latest_state(rec_dir: Path, max_frame: int
                      ) -> Tuple[Optional[Path], int]:
    """Newest checkpoint at or below ``max_frame`` (scan backward)."""
    for frame in range(max_frame, -1, -1):
        p = state_path(rec_dir, frame)
        if p.exists():
            return p, frame
    return None, -1


def save_state(rec_dir: Path, frame: int, positions: np.ndarray,
               velocities: np.ndarray, masses: Optional[np.ndarray] = None,
               keep_previous: bool = False) -> None:
    """Write a checkpoint; delete the one STATE_INTERVAL frames older.

    ``masses`` is an extra key beyond the reference layout: the reference
    never checkpoints masses and silently resets them to 1.0 on resume
    (``tools/record.py:752-753``), corrupting presets with non-uniform
    masses (ring/accretion_disk/...).  Reference-written states (without
    the key) still load.
    """
    arrays = {"positions": positions, "velocities": velocities}
    if masses is not None:
        arrays["masses"] = masses
    np.savez(state_path(rec_dir, frame), **arrays)
    if not keep_previous:
        old = state_path(rec_dir, frame - STATE_INTERVAL)
        if old.exists():
            old.unlink()


def load_state(path: Path
               ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    with np.load(path) as f:
        masses = f["masses"].copy() if "masses" in f else None
        return f["positions"].copy(), f["velocities"].copy(), masses


def list_recordings() -> list:
    """Inventory of sessions: (name, metadata, completed, total)."""
    root = recordings_root()
    out = []
    if not root.exists():
        return out
    for d in sorted(root.iterdir()):
        if not d.is_dir() or not (d / "metadata.json").exists():
            continue
        meta = load_metadata(d)
        done = get_completed_frames(d)
        out.append((d.name, meta, done, meta.get("total_frames", 0)))
    return out
