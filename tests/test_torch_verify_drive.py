"""The recorder's whole loop on the CPU (``tools/verify_drive.py``, the
port of ``scripts/verify_drive_1m.sh``): record at 8K bodies, SIGINT once
frames are on disk, status, resume, extend, decode the last frame.

Where the SIGINT lands depends on the machine's speed, so the test holds
only what holds wherever it lands (or when the recording ends first):
the session resumes to its total, the extension adds its frames, the
last frame decodes.  Each recorder command runs under a time limit.
"""

import json

from spatialsim_tpu_torch.tools import verify_drive

FRAMES, EXTEND, AT = 5, 1, 2
STEP_LIMIT_S = 240


def test_drive_resumes_extends_and_decodes(capsys, monkeypatch):
    # The recorder processes share the machine with the suite's workers.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    rc = verify_drive.main([
        "--preset", "tiny_galaxy", "--bodies", "8k", "--frames",
        str(FRAMES), "--interrupt-at", str(AT), "--extend", str(EXTEND),
        "--device", "cpu", "--timeout", str(STEP_LIMIT_S)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "VERIFY DRIVE OK" in out
    summary = json.loads(out.strip().splitlines()[-1])
    assert summary["bodies"] == 8000
    assert summary["resumed_frames"] == FRAMES
    assert summary["total_frames"] == FRAMES + EXTEND
    assert summary["decoded_frame"] == FRAMES + EXTEND - 1
    assert summary["paused_frames"] <= FRAMES
    if summary["signalled_at"] is not None:
        assert summary["signalled_at"] >= AT


def test_interrupt_must_fall_inside_the_recording():
    for at in (0, FRAMES):
        try:
            verify_drive.drive("tiny_galaxy", "8k", FRAMES, at, EXTEND,
                               "cpu")
        except ValueError as exc:
            assert "--interrupt-at" in str(exc)
        else:
            raise AssertionError(f"interrupt at {at} accepted")
