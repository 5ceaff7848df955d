"""The recorder's whole loop, end to end: record -> SIGINT mid-run ->
status -> resume -> extend -> decode (port of ``scripts/verify_drive.sh``
and ``scripts/verify_drive_1m.sh``).

    python -m spatialsim_tpu_torch.tools.verify_drive --preset bar_galaxy \\
        --bodies 1m --frames 100 --interrupt-at 40 --extend 20
    python -m spatialsim_tpu_torch.tools.verify_drive --preset tiny_galaxy \\
        --bodies 8k --frames 30 --interrupt-at 10 --extend 10 --device cpu

Runs ``python -m spatialsim_tpu_torch.tools.record`` as a subprocess with
a recordings directory of its own (``SPATIALSIM_RECORDINGS``, a temporary
directory), polls the frames on disk and sends SIGINT once
``--interrupt-at`` of them are there (a recording that ends first is not
interrupted), then runs ``--status``, ``--resume`` and ``--extend``, each
of which must exit 0, and requires the session to hold every frame after
the resume and the extension.  Last it decodes the final frame through
the port's ``io.codec`` (the delta chain from its key frame): positions
finite, colours in [0, 1] +- 1e-3.  Any failed step exits 1.  Each step
runs under ``--timeout`` seconds.  The last line is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from spatialsim_tpu_torch.io import codec, session

_ROOT = Path(__file__).resolve().parents[2]
POLL_S = 0.1


class DriveFailed(RuntimeError):
    pass


def _env(rec_root):
    return dict(os.environ, SPATIALSIM_RECORDINGS=str(rec_root),
                PYTHONPATH=os.pathsep.join(
                    [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")]
                                    if p]))


def _record_cmd(*args):
    return [sys.executable, "-m", "spatialsim_tpu_torch.tools.record", *args]


def _run(label, args, rec_root, timeout, out):
    """Run one recorder command to its end; its output's last lines are
    printed, a nonzero exit raises."""
    out(f"=== {label}", flush=True)
    t = time.perf_counter()
    proc = subprocess.run(_record_cmd(*args), cwd=_ROOT, env=_env(rec_root),
                          capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t
    for line in proc.stdout.splitlines()[-6:]:
        out("    " + line.strip(), flush=True)
    out(f"    rc {proc.returncode}, {secs:.1f} s", flush=True)
    if proc.returncode != 0:
        raise DriveFailed(f"{label}: rc {proc.returncode}\n"
                          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return proc.stdout


def record_and_interrupt(args, rec_dir, interrupt_at, timeout, out):
    """Start the recording, send SIGINT once ``interrupt_at`` frames are on
    disk; returns (frames on disk when signalled or None, the exit code)."""
    log = rec_dir.parent / "record.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(_record_cmd(*args), cwd=_ROOT,
                                env=_env(rec_dir.parent), stdout=f,
                                stderr=subprocess.STDOUT)
        signalled = None
        t0 = time.perf_counter()
        try:
            while proc.poll() is None:
                if time.perf_counter() - t0 > timeout:
                    raise DriveFailed(f"record: no end within {timeout} s")
                done = session.get_completed_frames(rec_dir)
                if done >= interrupt_at:
                    proc.send_signal(signal.SIGINT)
                    signalled = done
                    out(f"    SIGINT at {time.perf_counter() - t0:.1f} s, "
                        f"{done} frames on disk", flush=True)
                    break
                time.sleep(POLL_S)
            rc = proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for line in log.read_text().splitlines()[-4:]:
        out("    " + line.strip()[-200:], flush=True)
    return signalled, rc


def drive(preset="bar_galaxy", bodies="1m", frames=100, interrupt_at=40,
          extend=20, device="cuda", timeout=1200.0, name="verify_drive",
          out=print):
    """The drive; returns its summary (raises :class:`DriveFailed`)."""
    if not 0 < interrupt_at < frames:
        raise ValueError(f"--interrupt-at {interrupt_at} must lie in "
                         f"(0, {frames})")
    with tempfile.TemporaryDirectory(prefix="verify_drive_") as tmp:
        rec_root = Path(tmp)
        rec_dir = rec_root / name
        out(f"=== record {frames} frames of {preset} at {bodies} on "
            f"{device} (SIGINT at {interrupt_at} frames on disk)",
            flush=True)
        signalled, rc = record_and_interrupt(
            ["--preset", preset, "--bodies", bodies, "--frames",
             str(frames), "--name", name, "--device", device], rec_dir,
            interrupt_at, timeout, out)
        paused = session.get_completed_frames(rec_dir)
        out(f"    record rc {rc} (interrupt path); {paused} frames on disk",
            flush=True)
        status = _run("status", ["--status"], rec_root, timeout, out)
        if name not in status:
            raise DriveFailed(f"status does not list {name}:\n{status}")
        _run(f"resume to {frames}", ["--resume", name, "--device", device],
             rec_root, timeout, out)
        resumed = session.get_completed_frames(rec_dir)
        if resumed != frames:
            raise DriveFailed(f"resume left {resumed} of {frames} frames")
        _run(f"extend +{extend}", ["--extend", str(extend), name, "--device",
                                   device], rec_root, timeout, out)
        total = session.get_completed_frames(rec_dir)
        if total != frames + extend:
            raise DriveFailed(f"extend left {total} of {frames + extend} "
                              f"frames")
        last = total - 1
        n = int(session.load_metadata(rec_dir)["num_bodies"])
        p, c = codec.load_frame(rec_dir, last)
        if p.shape != (n, 3) or c.shape != (n, 3):
            raise DriveFailed(f"frame {last}: shapes {p.shape} {c.shape}")
        if not np.isfinite(p).all():
            raise DriveFailed(f"frame {last}: positions not finite")
        if c.min() < -1e-3 or c.max() > 1.0 + 1e-3:
            raise DriveFailed(f"frame {last}: colours in [{c.min()}, "
                              f"{c.max()}]")
        size = sum(f.stat().st_size for f in rec_dir.iterdir())
        out(f"=== decode OK: frame {last}, {n} bodies, colours in "
            f"[{c.min():.4f}, {c.max():.4f}]; session {size / 1e6:.1f} MB",
            flush=True)
    summary = {"preset": preset, "bodies": n, "frames": frames,
               "extend": extend, "signalled_at": signalled,
               "record_rc": rc, "paused_frames": paused,
               "resumed_frames": resumed, "total_frames": total,
               "decoded_frame": last, "session_mb": round(size / 1e6, 1),
               "device": device}
    out("VERIFY DRIVE OK", flush=True)
    out(json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="bar_galaxy")
    ap.add_argument("--bodies", default="1m", help="body count (k/m ok)")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--interrupt-at", type=int, default=40)
    ap.add_argument("--extend", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds each step may take")
    a = ap.parse_args(argv)
    if a.device.startswith("cuda"):
        import torch
        if not torch.cuda.is_available():
            print("verify_drive: device 'cuda' requested but "
                  "torch.cuda.is_available() is False; pass --device cpu",
                  file=sys.stderr)
            return 1
    try:
        drive(a.preset, a.bodies, a.frames, a.interrupt_at, a.extend,
              a.device, a.timeout)
    except (DriveFailed, subprocess.TimeoutExpired) as exc:
        print(f"VERIFY DRIVE FAILED: {exc}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
