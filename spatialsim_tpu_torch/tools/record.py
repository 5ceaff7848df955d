"""Offline frame recorder on the PyTorch port (port of
``spatialsim_tpu/tools/record.py``).

Same session layout, codec, checkpoint cadence (every 50 frames),
resume/extend contract and CLI flags as the JAX recorder, with the port's
own copies of its framework-neutral helpers (presets,
``config_from_preset``, progress bars, ``--status``); frames are
byte-compatible with the JAX recordings, so the JAX package's playback and
export read them as they are.  As in the JAX recorder, frame i is copied
and written while frame i+1 computes (:class:`FrameOverlap`).
``--device`` (default ``cuda``) picks the torch device; there is no silent
CPU fallback.  ``--estimate`` prints the wall-clock estimate
(:func:`estimate_recording_time`, anchored on the port's own H100
measurements) and exits without stepping.

    python -m spatialsim_tpu_torch.tools.record --preset bar_galaxy \\
        --bodies 1m --frames 10 --name demo
    python -m spatialsim_tpu_torch.tools.record --preset bar_galaxy \\
        --estimate
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import Optional

from spatialsim_tpu_torch import presets as presets_lib
from spatialsim_tpu_torch.config.nbody import NBodyConfig
from spatialsim_tpu_torch.io import (
    BackgroundCompressor, find_latest_state, get_completed_frames,
    get_recording_dir, list_recordings, load_metadata, load_state,
    save_frame, save_metadata, save_state)
from spatialsim_tpu_torch.io.session import STATE_INTERVAL

RECORD_MAX_SPEED_COLOR = 15.0

# Throughput anchors of the wall-clock estimate: the port's own numbers on
# an NVIDIA H100 80GB HBM3, 700.00 W (nvidia-smi's name and power limit),
# sustained, list rebuilds included.  The estimate follows the engine the
# model picks (models/nbody.resolve_engine): all-pairs up to the
# threshold, the window engine (n log n from the 1M rate) above it.  The
# JAX recorder also scans the repo's committed bench records for its 1M
# anchor; those are TPU runs, so this one reads no file and keeps to these
# constants.
#
# Each anchor is one reading of chip_smoke.py's phase 21 in the same run
# on NVIDIA H100 80GB HBM3, 700.00 W; the smoke prints this file's
# constants beside its own readings in phase 21 (d).
#
# 1M window anchor: the port bench's nbody_steps_per_sec_1000k_theta0.8
# (python -m spatialsim_tpu_torch.tools.bench, phase 21 (b); 96 steps in
# dispatches of 48, rebuilds included): 318.67 steps/s.
_EST_ANCHOR_N = 1_000_000
_EST_ANCHOR_THETA = 0.8
_EST_ANCHOR_STEP_S = 1.0 / 318.67
# Per-step floor (any engine, small N): the port bench at 10,000 bodies
# (--only 1m --bodies 10000 --engine allpairs, phase 21 (d)):
# 10066.581 steps/s.
_EST_STEP_FLOOR_S = 1.0 / 10066.581
# All-pairs pair rate: kernel 1 at N = 32,768 (phase 2), 0.7250 ms a call.
_EST_ALLPAIRS_PAIRS_PER_S = 32_768 ** 2 / 0.7250e-3
ESTIMATE_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def estimate_recording_time(config: dict) -> float:
    """Engine-aware wall-clock estimate (seconds) of a preset's recording
    on the card the anchors were measured on (:data:`ESTIMATE_CARD`)."""
    import math
    n = int(config["num_bodies"])
    theta = float(config.get("theta", 0.8))
    steps = int(config["total_frames"]) * int(config.get("substeps", 1))
    if n <= NBodyConfig().allpairs_threshold:
        # All-pairs kernel: the n^2 pair rate, with the step floor.
        step_s = max(_EST_STEP_FLOOR_S, n * n / _EST_ALLPAIRS_PAIRS_PER_S)
    else:
        scale = (n * math.log(max(n, 2))) / (
            _EST_ANCHOR_N * math.log(_EST_ANCHOR_N))
        theta_scale = (_EST_ANCHOR_THETA / theta) ** 2
        step_s = max(_EST_STEP_FLOOR_S,
                     _EST_ANCHOR_STEP_S * scale * theta_scale)
    return steps * step_s


def config_from_preset(preset: dict) -> NBodyConfig:
    """Map a preset dict onto the physics config."""
    return NBodyConfig(
        num_bodies=int(preset["num_bodies"]),
        theta=float(preset["theta"]),
        G=float(preset["G"]),
        softening=float(preset["softening"]),
        damping=float(preset["damping"]),
        spawn_radius=float(preset["spawn_radius"]),
        distribution=preset.get("distribution", "galaxy"),
    )


def format_time(seconds: float) -> str:
    seconds = int(seconds)
    if seconds < 60:
        return f"{seconds}s"
    if seconds < 3600:
        return f"{seconds // 60}m{seconds % 60:02d}s"
    return f"{seconds // 3600}h{(seconds % 3600) // 60:02d}m"


def _bar(frac: float, width: int = 40) -> str:
    filled = int(frac * width)
    return "█" * filled + "░" * (width - filled)


def print_progress(frame: int, total: int, frame_time: float, elapsed: float,
                   eta: float, comp_stats: dict, first: bool) -> None:
    """Nested render + compression bars (ANSI cursor reuse).

    Mirrors the reference recorder's two-bar display with a compression
    ETA derived from its rolling timing ring
    (the reference's ``tools/record.py:598-677``): the second bar tracks
    the background compressor through the frames rendered so far, ETA =
    backlog x average per-frame pack time.
    """
    frac = (frame + 1) / total
    render = (f"Render:   {frac * 100:5.1f}% | frame {frame + 1:5d}/{total}"
              f" | {frame_time * 1000:6.1f} ms/frame"
              f" | elapsed {format_time(elapsed):>6s} | ETA "
              f"{format_time(eta):>6s}")
    done = comp_stats["compressed"]
    if done:
        backlog = max(0, (frame + 1) - done)
        comp_eta = backlog * comp_stats["avg_time"]
        comp = (f"Compress: {done / total * 100:5.1f}% | frame {done:5d}"
                f"/{total} | {comp_stats['avg_time'] * 1000:6.1f} ms/frame"
                f" | backlog {backlog:5d} | ETA {format_time(comp_eta):>6s}")
        if comp_stats.get("failures"):
            comp += f" | {comp_stats['failures']} kept raw"
    else:
        comp = "Compress: waiting for first batch..."
    if not first:
        sys.stdout.write("\033[4A")
    sys.stdout.write(f"\033[K[{_bar(frac)}]\n\033[K{render}\n"
                     f"\033[K[{_bar(done / total)}]\n\033[K{comp}\n")
    sys.stdout.flush()





def _device_name(device) -> str:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type


def record(config: dict, resume: bool = False, device="cuda") -> None:
    """Run (or resume) one offline recording session on ``device``."""
    from spatialsim_tpu_torch.models.nbody import NBodySimulation

    rec_dir = get_recording_dir(config["session_name"])
    total_frames = int(config["total_frames"])
    substeps = int(config.get("substeps", 1))
    dt_frame = float(config["dt_per_frame"])
    sim_cfg = config_from_preset(config)

    start_frame = 0
    sim: Optional[NBodySimulation] = None

    if resume:
        completed = get_completed_frames(rec_dir)
        if completed > 0:
            print(f"[Record] Found {completed} completed frames")
            state_file, state_frame = find_latest_state(rec_dir, completed)
            if state_file is not None:
                print(f"[Record] Loading state from frame {state_frame}")
                positions, velocities, masses = load_state(state_file)
                sim = NBodySimulation.from_state(
                    positions, velocities, masses, config=sim_cfg,
                    substeps=substeps, device=device)
                start_frame = state_frame + 1
                print(f"[Record] Resuming from frame {start_frame}")
            else:
                print("[Record] No state checkpoint; restarting from frame 0")

    if sim is None:
        print(f"[Record] New session: {config['session_name']}")
        print(f"[Record] Bodies: {sim_cfg.num_bodies:,}  θ={sim_cfg.theta}  "
              f"distribution={sim_cfg.distribution}")
        print(f"[Record] Frames: {total_frames}  dt={dt_frame}  "
              f"substeps={substeps}")
        sim = NBodySimulation(config=sim_cfg, substeps=substeps,
                              seed=int(config.get("seed", 0)), device=device)
        save_metadata(rec_dir, config)

    compressor = BackgroundCompressor(rec_dir)
    compressor.start()
    print(f"\n[Record] Computing on {_device_name(sim.device)} "
          f"from frame {start_frame}; Ctrl-C pauses (resumable)\n")

    start_time = time.time()
    frame_times: list = []
    all_times: list = []
    write_times: list = []
    # Each frame advances dt_per_frame of simulated time in `substeps`
    # equal sub-iterations; the step runs `substeps` of the dt we pass.
    dt_sub = dt_frame / max(substeps, 1)
    frames = FrameOverlap(sim, rec_dir, compressor, write_times)
    stepped = start_frame - 1          # the last frame whose step ran

    try:
        for frame in range(start_frame, total_frames):
            t0 = time.time()
            sim.step_raw(dt_sub)
            stepped = frame
            # Queue frame `frame`'s copy, then write the previous frame
            # while this one's step and copy run on the device.
            frames.capture(frame)
            if (frame + 1) % STATE_INTERVAL == 0:
                frames.flush()         # a checkpoint names a written frame
                save_state(rec_dir, frame, sim.get_positions(),
                           sim.get_velocities(), sim.get_masses())

            frame_times.append(time.time() - t0)
            all_times.append(frame_times[-1])
            del frame_times[:-10]
            avg = sum(frame_times) / len(frame_times)
            print_progress(frame, total_frames, frame_times[-1],
                           time.time() - start_time,
                           avg * (total_frames - frame - 1),
                           compressor.stats(),
                           first=(frame == start_frame))
        frames.flush()
        # Final checkpoint so --extend resumes instantly.
        save_state(rec_dir, total_frames - 1, sim.get_positions(),
                   sim.get_velocities(), sim.get_masses(),
                   keep_previous=True)
        compressor.compress_remaining(total_frames)
        compressor.stop()
        s = compressor.stats()
        print(f"\n[Record] ✓ Complete in "
              f"{format_time(time.time() - start_time)}")
        if all_times:
            print(f"[Record] Frame time: median "
                  f"{statistics.median(all_times) * 1e3:.3f} ms over "
                  f"{len(all_times)} frames (step, capture and the previous "
                  f"frame's write); writing a frame: median "
                  f"{statistics.median(write_times) * 1e3:.3f} ms")
        print(f"[Compress] {s['compressed']} frames packed, "
              f"{s['ratio'] * 100:.1f}% size reduction")
        print(f"[Record] Output: {rec_dir}")
        print(f"[Record] Playback: python -m "
              f"spatialsim_tpu_torch.tools.playback {config['session_name']}")
    except KeyboardInterrupt:
        # Every frame whose step ran is written, and the checkpoint holds
        # the state after the last of them, so a resume finds every frame
        # it counts as completed and continues from the next one.
        frames.flush()
        if frames.written < stepped:
            frames.capture(stepped)
            frames.flush()
        print(f"\n\n[Record] Paused after frame {stepped}")
        if stepped >= 0:
            save_state(rec_dir, stepped, sim.get_positions(),
                       sim.get_velocities(), sim.get_masses(),
                       keep_previous=True)
        print("[Record] Finishing compression of staged frames...")
        compressor.compress_remaining(stepped + 1)
        compressor.stop()
        print(f"[Record] To resume: python -m spatialsim_tpu_torch.tools."
              f"record --resume {config['session_name']}")


class FrameOverlap:
    """Frame i's copy and write overlap frame i+1's step (the JAX
    recorder's ``flush_pending``).

    :meth:`capture` queues a frame's device-to-host copies (positions and
    colours, original body order) into the next of two alternating host
    buffers -- pinned, with ``non_blocking`` copies and a CUDA event on the
    card -- and writes the frame captured before it, waiting on its event.
    :meth:`flush` writes the pending frame.  On the CPU the same code runs
    with plain buffers and synchronous copies.  ``written`` is the last
    frame written; ``write_times`` gets each write's seconds (the wait on
    the copy included).
    """

    def __init__(self, sim, rec_dir, compressor, write_times):
        self.sim, self.rec_dir, self.compressor = sim, rec_dir, compressor
        self.write_times = write_times
        self.cuda = sim.device.type == "cuda"
        self.buffers = [None, None]
        self.pending = None            # (frame, pos, col, event)
        self.written = -1

    def _buffers(self, k, shape):
        import torch
        if self.buffers[k % 2] is None:
            self.buffers[k % 2] = tuple(
                torch.empty(shape, dtype=torch.float32, pin_memory=self.cuda)
                for _ in range(2))
        return self.buffers[k % 2]

    def capture(self, frame: int) -> None:
        import torch
        from spatialsim_tpu_torch.ops.colors import colors_by_velocity
        # Original body order (the window engine's state lives
        # Morton-sorted), (N, 3) rows as the frame files hold them.
        pos_o, vel_o = self.sim.device_frame()
        pos_d = pos_o.T.contiguous()
        col_d = colors_by_velocity(vel_o,
                                   RECORD_MAX_SPEED_COLOR).T.contiguous()
        pos_h, col_h = self._buffers(frame, tuple(pos_d.shape))
        pos_h.copy_(pos_d, non_blocking=self.cuda)
        col_h.copy_(col_d, non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        self.flush()
        self.pending = (frame, pos_h, col_h, event)

    def flush(self) -> None:
        if self.pending is None:
            return
        t = time.time()
        frame, pos_h, col_h, event = self.pending
        if event is not None:
            event.synchronize()
        save_frame(self.rec_dir, frame, pos_h.numpy(), col_h.numpy())
        self.compressor.check_and_queue(frame)
        self.pending = None
        self.written = frame
        self.write_times.append(time.time() - t)


def select_preset_interactive(input_fn=input) -> Optional[dict]:
    """Preset menu with per-field overrides and a confirm step.

    Mirrors the reference's interactive flow
    (the reference's ``tools/record.py:1020-1113``): select by index,
    show the config, prompt for bodies/frames/theta overrides (Enter
    keeps the preset value; theta clamped to 0.1-2.0), show the
    wall-clock estimate of the final configuration and confirm before
    returning.  ``input_fn`` is injectable for tests.  Returns None on
    quit/EOF.
    """
    presets_lib.print_preset_menu()
    max_idx = len(presets_lib.get_preset_list()) - 1
    while True:
        try:
            choice = input_fn("\n  Selection: ").strip().lower()
        except (EOFError, KeyboardInterrupt):
            print("\n  Cancelled.")
            return None
        if choice in ("q", "quit", "exit", ""):
            print("\n  Cancelled.")
            return None
        try:
            idx = int(choice)
        except ValueError:
            print(f"  Invalid input. Enter a number 0-{max_idx} or 'q'.")
            continue
        key, preset = presets_lib.get_preset_by_index(idx)
        if key is None:
            print(f"  Invalid selection. Enter 0-{max_idx} or 'q' to quit.")
            continue
        config = presets_lib.get_preset_config(key)
        print(f"\n  Selected: [{idx}] {preset.get('name', key)}")
        print(f"  Distribution: {config['distribution']}")
        print(f"  Bodies: {config['num_bodies']:,}")
        print(f"  Frames: {config['total_frames']}")
        print(f"  Theta: {config['theta']}")
        print("\n  --- Optional Overrides (press Enter to skip) ---")
        try:
            raw = input_fn(f"  Bodies [{config['num_bodies']:,}]: ").strip()
            if raw:
                try:
                    val = presets_lib.parse_number(raw)
                    if val > 0:
                        config["num_bodies"] = val
                        print(f"    -> Bodies set to {val:,}")
                except ValueError:
                    print(f"    -> Invalid, keeping {config['num_bodies']:,}")
            raw = input_fn(f"  Frames [{config['total_frames']}]: ").strip()
            if raw:
                try:
                    val = int(raw)
                    if val > 0:
                        config["total_frames"] = val
                        print(f"    -> Frames set to {val}")
                except ValueError:
                    print(f"    -> Invalid, keeping {config['total_frames']}")
            raw = input_fn(f"  Theta [{config['theta']}]: ").strip()
            if raw:
                try:
                    val = float(raw)
                    if 0.1 <= val <= 2.0:
                        config["theta"] = val
                        print(f"    -> Theta set to {val}")
                    else:
                        print(f"    -> Theta must be 0.1-2.0, keeping "
                              f"{config['theta']}")
                except ValueError:
                    print(f"    -> Invalid, keeping {config['theta']}")
        except (EOFError, KeyboardInterrupt):
            print("\n  Cancelled.")
            return None
        est = estimate_recording_time(config)
        print("\n  --- Final Configuration ---")
        print(f"  Bodies: {config['num_bodies']:,}")
        print(f"  Frames: {config['total_frames']}")
        print(f"  Theta: {config['theta']}")
        print(f"  Estimated time: ~{format_time(est)} ({ESTIMATE_CARD})")
        try:
            confirm = input_fn("\n  Start recording? [Y/n]: ").strip().lower()
        except (EOFError, KeyboardInterrupt):
            print("\n  Cancelled.")
            return None
        if confirm in ("", "y", "yes"):
            return config
        presets_lib.print_preset_menu()


def print_status() -> None:
    rows = list_recordings()
    if not rows:
        print("No recordings found")
        return
    print(f"{'session':<28} {'frames':>12} {'bodies':>10} {'distribution':<14}")
    print("-" * 70)
    for name, meta, done, total in rows:
        print(f"{name:<28} {done:>5}/{total:<6} "
              f"{meta.get('num_bodies', 0):>10,} "
              f"{meta.get('distribution', '?'):<14}")


def extend_session(session: str, extra_frames: int) -> Optional[dict]:
    """Raise total_frames in metadata and return the updated config."""
    rec_dir = get_recording_dir(session, create=False)
    if not (rec_dir / "metadata.json").exists():
        print(f"[Record] Unknown session {session}")
        return None
    meta = load_metadata(rec_dir)
    meta["total_frames"] = int(meta["total_frames"]) + extra_frames
    save_metadata(rec_dir, meta, meta.get("start_time"))
    print(f"[Record] Extended {session} to {meta['total_frames']} frames")
    return meta



def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Record an N-body simulation to frames (PyTorch/CUDA)")
    p.add_argument("session", nargs="?", help="session name (for --resume)")
    p.add_argument("--preset", help="preset key (see --list-presets)")
    p.add_argument("--preset-id", type=int, help="preset menu index")
    p.add_argument("--resume", metavar="SESSION", nargs="?", const="",
                   help="resume a paused session")
    p.add_argument("--extend", type=int, metavar="N",
                   help="add N frames to a finished session and resume")
    p.add_argument("--status", action="store_true",
                   help="list recordings and their progress")
    p.add_argument("--list", dest="list_", action="store_true",
                   help="alias for --status")
    p.add_argument("--list-presets", action="store_true")
    p.add_argument("--list-distributions", action="store_true")
    p.add_argument("--estimate", action="store_true",
                   help="print the wall-clock estimate and exit")
    p.add_argument("--bodies", type=str, help="override body count (k/m ok)")
    p.add_argument("--frames", type=int, help="override total frames")
    p.add_argument("--theta", type=float, help="override Barnes-Hut theta")
    p.add_argument("--dt", type=float, help="override dt per frame")
    p.add_argument("--substeps", type=int, help="override substeps")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--name", help="session name override")
    p.add_argument("--device", default="cuda",
                   help="torch device for the simulation (default cuda)")
    args = p.parse_args(argv)
    if args.estimate:
        import torch
        if (torch.device(args.device).type == "cuda"
                and not torch.cuda.is_available()):
            print(f"[Record] device {args.device!r} requested but "
                  f"torch.cuda.is_available() is False; pass --device cpu")
            return 1

    if args.status or args.list_:
        print_status()
        return 0
    if args.list_presets:
        presets_lib.print_preset_menu()
        return 0
    if args.list_distributions:
        presets_lib.list_distributions()
        return 0

    session = args.session or (args.resume if args.resume else None)
    if args.extend is not None:
        if not session:
            p.error("--extend requires a session name")
        meta = extend_session(session, args.extend)
        if meta is None:
            return 1
        record(meta, resume=True, device=args.device)
        return 0
    if args.resume is not None:
        if not session:
            p.error("--resume requires a session name")
        rec_dir = get_recording_dir(session, create=False)
        if not (rec_dir / "metadata.json").exists():
            print(f"[Record] Unknown session {session}")
            return 1
        record(load_metadata(rec_dir), resume=True, device=args.device)
        return 0

    if args.preset:
        config = presets_lib.get_preset_config(args.preset)
        if config is None:
            print(f"Unknown preset {args.preset!r}; use --list-presets")
            return 1
    elif args.preset_id is not None:
        key, _ = presets_lib.get_preset_by_index(args.preset_id)
        if key is None:
            print(f"Preset index {args.preset_id} out of range")
            return 1
        config = presets_lib.get_preset_config(key)
    else:
        config = select_preset_interactive()
        if config is None:
            return 0

    # CLI overrides (precedence: preset < flag).
    if args.bodies:
        config["num_bodies"] = presets_lib.parse_number(args.bodies)
    if args.frames:
        config["total_frames"] = args.frames
    if args.theta:
        config["theta"] = args.theta
    if args.dt:
        config["dt_per_frame"] = args.dt
    if args.substeps:
        config["substeps"] = args.substeps
    if args.seed:
        config["seed"] = args.seed
    if args.name:
        config["session_name"] = args.name

    est = estimate_recording_time(config)
    print(f"[Record] Estimated compute: ~{format_time(est)} "
          f"({config['num_bodies']:,} bodies x "
          f"{config['total_frames']} frames; {est:.3f} s on "
          f"{ESTIMATE_CARD})")
    if args.estimate:
        return 0

    record(config, resume=False, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
