"""Host-side IO: frame codec, session layout, background compression.

The recording directory format is byte-compatible with the reference
(``tools/record.py``; documented at reference ``README.md:261-272``), so
recordings interchange between the two frameworks:

    recordings/<session>/
        metadata.json            preset config + start time
        frame_%04d.npz | .zstd   positions+colors (f32), zstd+delta packed
        state_%04d.npz           positions+velocities checkpoint every 50
"""

from spatialsim_tpu_torch.io.codec import (  # noqa: F401
    compress_frame, decompress_frame, save_frame, load_frame)
from spatialsim_tpu_torch.io.session import (  # noqa: F401
    get_recording_dir, save_metadata, load_metadata, get_completed_frames,
    find_latest_state, save_state, load_state, list_recordings)
from spatialsim_tpu_torch.io.compressor import BackgroundCompressor  # noqa: F401
