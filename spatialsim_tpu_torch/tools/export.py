"""Video export.

Re-design of the reference exporter (``tools/export.py:263-608``) for
headless machines: instead of an off-screen OpenGL window piped into an
ffmpeg subprocess (reference ``:327-339,484-529``), frames render through
the numpy software rasterizer and encode via:

* an ``ffmpeg`` rawvideo pipe when the binary exists (same arg builders:
  h264/h265/vp9, CRF quality tiers), or
* OpenCV ``VideoWriter`` (mp4v) as the no-ffmpeg fallback.

Same session format, camera animation modes, resolutions and quality
presets as the reference; sequential delta-aware frame loading keeps the
previous frame so every load is O(1) (reference ``:494-519``).
"""

from __future__ import annotations

import argparse
import dataclasses
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional


from spatialsim_tpu_torch.io import codec, session
from spatialsim_tpu_torch.render import ExportCamera, render_points

RESOLUTIONS = {
    "720p": (1280, 720),
    "1080p": (1920, 1080),
    "1440p": (2560, 1440),
    "4k": (3840, 2160),
}

# CRF tiers as in the reference (tools/export.py:88-109).
QUALITY_CRF = {"draft": 28, "good": 23, "high": 18, "ultra": 15}


@dataclasses.dataclass
class ExportConfig:
    session_name: str
    output: Optional[str] = None
    resolution: str = "1080p"
    fps: int = 30
    quality: str = "high"
    codec_name: str = "h264"
    camera_mode: str = "orbit"
    camera_radius: Optional[float] = None
    camera_theta: float = 45.0
    camera_phi: float = 25.0
    rotation_speed: float = 0.3
    point_size: float = 2.0
    brightness: float = 1.0
    start_frame: int = 0
    end_frame: Optional[int] = None

    @property
    def size(self):
        return RESOLUTIONS[self.resolution]


def unique_output_path(base: Path) -> Path:
    """name.mp4, name (1).mp4, ... (reference tools/export.py:299-313)."""
    if not base.exists():
        return base
    k = 1
    while True:
        cand = base.with_name(f"{base.stem} ({k}){base.suffix}")
        if not cand.exists():
            return cand
        k += 1


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def _ffmpeg_args(cfg: ExportConfig, out: Path):
    w, h = cfg.size
    crf = QUALITY_CRF[cfg.quality]
    base = ["ffmpeg", "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
            "-s", f"{w}x{h}", "-pix_fmt", "rgb24", "-r", str(cfg.fps),
            "-i", "-", "-an"]
    if cfg.codec_name == "h264":
        base += ["-vcodec", "libx264", "-crf", str(crf),
                 "-preset", "slow", "-pix_fmt", "yuv420p",
                 "-tune", "film"]
    elif cfg.codec_name == "h265":
        base += ["-vcodec", "libx265", "-crf", str(crf),
                 "-preset", "slow", "-pix_fmt", "yuv420p"]
    elif cfg.codec_name == "vp9":
        base += ["-vcodec", "libvpx-vp9", "-crf", str(crf), "-b:v", "0"]
    else:
        raise ValueError(f"unknown codec {cfg.codec_name}")
    return base + [str(out)]


class VideoExporter:
    """Renders a recording into a video file."""

    def __init__(self, cfg: ExportConfig):
        self.cfg = cfg
        self.rec_dir = session.get_recording_dir(cfg.session_name,
                                                 create=False)
        self.meta = session.load_metadata(self.rec_dir)
        self.total = session.get_completed_frames(self.rec_dir)
        if self.total == 0:
            raise FileNotFoundError(f"no frames in {self.rec_dir}")

    def export(self) -> Path:
        cfg = self.cfg
        w, h = cfg.size
        start = cfg.start_frame
        end = min(cfg.end_frame or self.total, self.total)
        n_frames = end - start
        radius = cfg.camera_radius or self.meta.get("spawn_radius",
                                                    500.0) * 1.6
        cam = ExportCamera(radius=radius, theta=cfg.camera_theta,
                           phi=cfg.camera_phi, mode=cfg.camera_mode,
                           rotation_speed=cfg.rotation_speed)

        out = Path(cfg.output) if cfg.output else \
            self.rec_dir / f"{cfg.session_name}.mp4"
        out = unique_output_path(out)

        use_ffmpeg = ffmpeg_available()
        writer = proc = None
        if use_ffmpeg:
            proc = subprocess.Popen(_ffmpeg_args(cfg, out),
                                    stdin=subprocess.PIPE,
                                    stdout=subprocess.DEVNULL,
                                    stderr=subprocess.DEVNULL)
            print(f"[Export] encoding with ffmpeg ({cfg.codec_name}, "
                  f"crf {QUALITY_CRF[cfg.quality]})")
        else:
            import cv2
            writer = cv2.VideoWriter(
                str(out), cv2.VideoWriter_fourcc(*"mp4v"), cfg.fps, (w, h))
            print("[Export] ffmpeg not found; encoding with OpenCV (mp4v)")

        print(f"[Export] {n_frames} frames @ {w}x{h} {cfg.fps}fps, "
              f"camera={cfg.camera_mode}")
        t0 = time.time()
        prev = (None, None)
        # Delta chains decode sequentially from 0 even if start > 0.
        for k in range(0, end):
            prev = codec.load_frame(self.rec_dir, k, *prev)
            if k < start:
                continue
            pos, col = prev
            cam.update(k - start, n_frames)
            img = render_points(pos, col, cam.get_position(),
                                up=cam.get_up(), width=w, height=h,
                                point_size=cfg.point_size,
                                brightness=cfg.brightness)
            if proc is not None:
                proc.stdin.write(img.tobytes())
            else:
                writer.write(img[:, :, ::-1])  # BGR for OpenCV
            done = k - start + 1
            if done % 25 == 0 or done == n_frames:
                el = time.time() - t0
                fps_now = done / el
                print(f"\r[Export] {done}/{n_frames} "
                      f"({fps_now:.1f} fps, ETA "
                      f"{(n_frames - done) / max(fps_now, 1e-9):.0f}s)",
                      end="", flush=True)
        print()
        if proc is not None:
            proc.stdin.close()
            proc.wait()
        else:
            writer.release()
        size_mb = out.stat().st_size / 1e6
        print(f"[Export] ✓ {out} ({size_mb:.1f} MB, "
              f"{time.time() - t0:.0f}s)")
        return out


def prompt(text: str, default, cast=str, choices=None):
    """One wizard prompt: ENTER keeps the default, bad input re-asks.

    Mirrors the reference's interactive config prompts
    (``tools/export.py:793-1042``, ``tools/playback.py:639-733``).
    """
    while True:
        label = f"{text} [{default}]"
        if choices:
            label += f" ({'/'.join(str(c) for c in choices)})"
        try:
            raw = input(f"{label}: ").strip()
        except EOFError:
            return default
        if not raw:
            return default
        try:
            val = cast(raw)
        except ValueError:
            print(f"  invalid {cast.__name__}: {raw!r}")
            continue
        if choices and val not in choices:
            print(f"  pick one of: {', '.join(str(c) for c in choices)}")
            continue
        return val


def pick_session() -> Optional[str]:
    """Numbered recording menu -> session name (or None)."""
    rows = session.list_recordings()
    if not rows:
        print("No recordings found")
        return None
    print("\nRecordings:")
    for i, (name, meta, done, total) in enumerate(rows, 1):
        print(f"  {i:2d}. {name:<28} {done}/{total} frames  "
              f"{meta.get('num_bodies', 0):,} bodies")
    try:
        raw = input("\nSession (number or name, ENTER aborts): ").strip()
    except EOFError:
        return None
    if not raw:
        return None
    if raw.isdigit() and 1 <= int(raw) <= len(rows):
        return rows[int(raw) - 1][0]
    return raw


def export_wizard() -> Optional[ExportConfig]:
    """Interactive export configuration (reference tools/export.py:793-1042)."""
    name = pick_session()
    if name is None:
        return None
    return ExportConfig(
        session_name=name,
        resolution=prompt("Resolution", "1080p",
                          choices=sorted(RESOLUTIONS)),
        quality=prompt("Quality", "high", choices=sorted(QUALITY_CRF)),
        codec_name=prompt("Codec", "h264", choices=["h264", "h265", "vp9"]),
        camera_mode=prompt("Camera mode", "orbit",
                           choices=list(ExportCamera.MODES)),
        fps=prompt("FPS", 30, int),
        point_size=prompt("Point size", 2.0, float),
        brightness=prompt("Brightness", 1.0, float),
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Export a recording to video")
    p.add_argument("session", nargs="?")
    p.add_argument("--output", "-o")
    p.add_argument("--resolution", choices=sorted(RESOLUTIONS), default="1080p")
    p.add_argument("--fps", type=int, default=30)
    p.add_argument("--quality", choices=sorted(QUALITY_CRF), default="high")
    p.add_argument("--codec", dest="codec_name",
                   choices=["h264", "h265", "vp9"], default="h264")
    p.add_argument("--camera", dest="camera_mode",
                   choices=ExportCamera.MODES, default="orbit")
    p.add_argument("--radius", type=float, dest="camera_radius")
    p.add_argument("--point-size", type=float, default=2.0)
    p.add_argument("--brightness", type=float, default=1.0)
    p.add_argument("--start", type=int, default=0, dest="start_frame")
    p.add_argument("--end", type=int, dest="end_frame")
    p.add_argument("--list", dest="list_", action="store_true")
    args = p.parse_args(argv)

    if args.list_:
        for name, meta, done, total in session.list_recordings():
            print(f"  {name:<28} {done}/{total} frames")
        return 0
    if not args.session:
        # Interactive wizard when no session was named on the CLI.
        cfg = export_wizard()
        if cfg is None:
            return 1
        VideoExporter(cfg).export()
        return 0

    cfg = ExportConfig(
        session_name=args.session, output=args.output,
        resolution=args.resolution, fps=args.fps, quality=args.quality,
        codec_name=args.codec_name, camera_mode=args.camera_mode,
        camera_radius=args.camera_radius, point_size=args.point_size,
        brightness=args.brightness, start_frame=args.start_frame,
        end_frame=args.end_frame)
    VideoExporter(cfg).export()
    return 0


if __name__ == "__main__":
    sys.exit(main())
