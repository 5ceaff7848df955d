"""Offline frame recorder on the PyTorch port (port of
``spatialsim_tpu/tools/record.py``).

Same session layout, codec, checkpoint cadence (every 50 frames),
resume/extend contract and CLI flags as the JAX recorder, whose
framework-neutral helpers (presets, ``config_from_preset``, progress
bars, ``--status``) it reuses; frames are byte-compatible with the JAX
recordings, so the JAX package's playback and export read them as they
are.  ``--device`` (default ``cuda``) picks the torch device; there is no
silent CPU fallback.

    python -m spatialsim_tpu_torch.tools.record --preset bar_galaxy \\
        --bodies 1m --frames 10 --name demo
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

from spatialsim_tpu import presets as presets_lib
from spatialsim_tpu.io import (
    BackgroundCompressor, find_latest_state, get_completed_frames,
    get_recording_dir, load_metadata, load_state, save_frame, save_metadata,
    save_state)
from spatialsim_tpu.io.session import STATE_INTERVAL
from spatialsim_tpu.tools.record import (
    RECORD_MAX_SPEED_COLOR, config_from_preset, extend_session, format_time,
    print_progress, print_status, select_preset_interactive)


def _device_name(device) -> str:
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type


def record(config: dict, resume: bool = False, device="cuda") -> None:
    """Run (or resume) one offline recording session on ``device``."""
    from spatialsim_tpu_torch.models.nbody import NBodySimulation
    from spatialsim_tpu_torch.ops.colors import colors_by_velocity

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
    frame = start_frame
    # Each frame advances dt_per_frame of simulated time in `substeps`
    # equal sub-iterations; the step runs `substeps` of the dt we pass.
    dt_sub = dt_frame / max(substeps, 1)

    try:
        for frame in range(start_frame, total_frames):
            t0 = time.time()
            sim.step_raw(dt_sub)
            # Capture in original body order (the window engine's state
            # lives Morton-sorted); the host copy synchronises.
            pos_o, vel_o = sim.device_frame()
            col = colors_by_velocity(vel_o, RECORD_MAX_SPEED_COLOR)
            save_frame(rec_dir, frame, pos_o.T.contiguous().cpu().numpy(),
                       col.T.contiguous().cpu().numpy())
            compressor.check_and_queue(frame)

            if (frame + 1) % STATE_INTERVAL == 0:
                save_state(rec_dir, frame, sim.get_positions(),
                           sim.get_velocities(), sim.get_masses())

            frame_times.append(time.time() - t0)
            del frame_times[:-10]
            avg = sum(frame_times) / len(frame_times)
            print_progress(frame, total_frames, frame_times[-1],
                           time.time() - start_time,
                           avg * (total_frames - frame - 1),
                           compressor.stats(),
                           first=(frame == start_frame))
        # Final checkpoint so --extend resumes instantly.
        save_state(rec_dir, total_frames - 1, sim.get_positions(),
                   sim.get_velocities(), sim.get_masses(),
                   keep_previous=True)
        compressor.compress_remaining(total_frames)
        compressor.stop()
        s = compressor.stats()
        print(f"\n[Record] ✓ Complete in "
              f"{format_time(time.time() - start_time)}")
        print(f"[Compress] {s['compressed']} frames packed, "
              f"{s['ratio'] * 100:.1f}% size reduction")
        print(f"[Record] Output: {rec_dir}")
        print(f"[Record] Playback: python -m spatialsim_tpu.tools.playback "
              f"{config['session_name']}")
    except KeyboardInterrupt:
        print(f"\n\n[Record] Paused at frame {frame}")
        save_state(rec_dir, frame, sim.get_positions(), sim.get_velocities(),
                   sim.get_masses(), keep_previous=True)
        print("[Record] Finishing compression of staged frames...")
        compressor.compress_remaining(frame + 1)
        compressor.stop()
        print(f"[Record] To resume: python -m spatialsim_tpu_torch.tools."
              f"record --resume {config['session_name']}")


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

    record(config, resume=False, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
