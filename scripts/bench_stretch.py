#!/usr/bin/env python
"""Stretch-mode (--stretch_audio) wall-clock datapoint at Ask-Dad scale.

The round-3 review noted PERF.md had no measured cost for the stretch path
(the reference's replace_aligned_segments, describealign.py:230-416, which
the repo replaces with the phase vocoder / resampler / WSOLA splicer).
This measures, on the Ask-Dad-scale bench pair:

  - alignment (shared with the default mode, for context),
  - replace_aligned_segments with the default phase vocoder
    (DESCRIBEALIGN_PV=host and =device),
  - with --no_pitch_correction (quadratic resampler only),
  - with DESCRIBEALIGN_WSOLA=1 (reference-parity splicer),

each over the stereo float32 arrays combine() would hand it. Run solo
(the device is needed only for the alignment and the PV=device variant).

Usage: python scripts/bench_stretch.py [reps]
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    from bench import build_batch_pairs
    from describealign_jax.alignment.api import align_from_pcm, _pad_pcm_i16
    from describealign_jax.stretch.segments import replace_aligned_segments

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print("backend:", jax.default_backend(), flush=True)

    # the 3%-rate-changed batch member: its segments sit between the JND
    # (0.5%) and the 10% skip rule, so the phase vocoder actually runs
    # (a slope-1.0 pair routes every segment to the resampler instead)
    pairs, lens, planted, kinds = build_batch_pairs()
    video, audio = pairs[kinds.index("rate")]
    sv, sa = video.shape[1], audio.shape[1]
    # stereo f32 arrays exactly as combine() builds them (stretch mode)
    video_st = np.broadcast_to(video, (2, sv)).astype(np.float16).astype(
        np.float32).copy()
    audio_st = np.broadcast_to(audio, (2, sa)).astype(np.float16).astype(
        np.float32).copy()

    import io
    from contextlib import redirect_stdout
    quiet = io.StringIO()
    t = time.time()
    with redirect_stdout(quiet):
        x, y, sim, path, m = align_from_pcm(_pad_pcm_i16(video),
                                            _pad_pcm_i16(audio),
                                            video_samples=sv,
                                            audio_samples=sa)[:5]
    print(f"alignment (context): {time.time() - t:6.2f} s  "
          f"sim {sim:.1f}%", flush=True)

    def run(tag, env):
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            best = float('inf')
            for _ in range(reps):
                va = video_st.copy()
                t0 = time.time()
                with redirect_stdout(quiet):
                    replace_aligned_segments(
                        va, audio_st.copy(), x, y,
                        no_pitch_correction=tag.startswith('no_pitch'))
                best = min(best, time.time() - t0)
            print(f"{tag:22s} {best:6.2f} s  "
                  f"({sv / 44100 / 60 / best:5.2f} video-min/s)", flush=True)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    run("wsola (default)", {})
    run("pv host", {"DESCRIBEALIGN_STRETCH": "pv", "DESCRIBEALIGN_PV": "host"})
    run("pv device", {"DESCRIBEALIGN_STRETCH": "pv",
                      "DESCRIBEALIGN_PV": "device"})
    run("no_pitch (host resample)", {})
    run("no_pitch (device resample)", {"DESCRIBEALIGN_RESAMPLE": "device"})


if __name__ == "__main__":
    main()
