"""Default (video-retime) mode end-to-end through fake ffmpeg binaries.

The reference's primary mode - decode via ffmpeg, keyframe probe, setts
expression, stream-copy mux - has no real ffmpeg in this environment, so
executable stand-ins (tests/fakebin.py) emulate the exact subprocess
contract and record every argv for assertions. This drives pipeline.py's
default branch for real: files in, combined file + plot + report out.
"""
import json
import os
import stat
import sys

import pytest

FAKEBIN = os.path.join(os.path.dirname(__file__), "fakebin.py")


@pytest.fixture()
def fake_ffmpeg_env(tmp_path, monkeypatch):
    from describealign_jax.media import ffmpeg as ff
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for tool in ("ffmpeg", "ffprobe"):
        shim = bindir / tool
        shim.write_text(f"#!/bin/sh\nexec '{sys.executable}' '{FAKEBIN}' "
                        f"{tool} \"$@\"\n")
        shim.chmod(shim.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("DESCRIBEALIGN_FFMPEG", str(bindir / "ffmpeg"))
    monkeypatch.setenv("DESCRIBEALIGN_FFPROBE", str(bindir / "ffprobe"))
    ff._reset_discovery_cache()
    yield
    ff._reset_discovery_cache()


@pytest.fixture(scope="module")
def media_pair(tmp_path_factory):
    """Video with a 6 s undescribed intro; description covers the rest.

    Gives a POSITIVE video offset, so the default mode cuts the video at a
    keyframe (the reference's `-ss` branch) instead of just offsetting."""
    import numpy as np
    from describealign_jax.media.decode import write_wav
    from tests.synth import speech_like
    tmp = tmp_path_factory.mktemp("fake_media")
    content = speech_like(40.0, seed=9)
    intro = speech_like(6.0, seed=1009, amp=5000.0)
    video = np.concatenate([intro, content])[None, :]
    audio = content[None, :]
    video_file = tmp / "episode_1.mp4"     # WAV payload, video extension
    audio_file = tmp / "described_1.wav"
    write_wav(video_file, video)
    write_wav(audio_file, audio)
    return str(video_file), str(audio_file)


def test_default_mode_end_to_end(fake_ffmpeg_env, media_pair, tmp_path):
    import describealign_jax as da
    from describealign_jax.media.decode import parse_audio_int16

    video_file, audio_file = media_pair
    out_dir, plot_dir = str(tmp_path / "out"), str(tmp_path / "plots")
    da.combine([video_file], [audio_file], yes=True,
               output_dir=out_dir, alignment_dir=plot_dir)

    out_file = os.path.join(out_dir, "ad_episode_1.mp4")
    assert os.path.exists(out_file)

    args = json.load(open(out_file + ".ffargs.json"))
    # stream-copy + setts retime contract (reference describealign.py:489-510)
    assert args[args.index('-vcodec') + 1] == 'copy'
    assert args[args.index('-scodec') + 1] == 'copy'
    # wav description audio must be re-encoded aac in a video container
    assert args[args.index('-acodec') + 1] == 'aac'
    assert '-movflags' in args and 'frag_keyframe' in args
    assert args[args.index('-max_interleave_delta') + 1] == '0'
    bsf_v = args[args.index('-bsf:v') + 1]
    assert bsf_v.startswith("setts=pts='TS+(0") and ":dts='TS+(0" in bsf_v
    bsf_s = args[args.index('-bsf:s') + 1]
    assert "duration='DURATION*" in bsf_s
    assert args[args.index('-disposition:a:0') + 1] == \
        'default+visual_impaired+descriptions'

    # the -ss cut must land on a keyframe midpoint near the 6 s offset
    # (fake keyframes every 2 s -> midpoints are odd integers)
    ss = float(args[args.index('-ss') + 1])
    assert 4.0 <= ss <= 8.0
    assert abs(ss - round(ss)) < 1e-6 and int(round(ss)) % 2 == 1

    # the fake muxer applied the cut: output shorter than the video by ss
    video_pcm = parse_audio_int16(video_file, 1)
    out_pcm = parse_audio_int16(out_file, 1)
    expect = video_pcm.shape[1] - int(ss * 44100)
    assert abs(out_pcm.shape[1] - expect) <= 1

    # report artifacts carry the exact command (reference 226-227)
    report = open(os.path.join(plot_dir, "episode_1.txt")).read()
    assert "setts=pts=" in report
    assert "Start Offset:" in report
    assert os.path.exists(os.path.join(plot_dir, "episode_1.png"))


def test_stretch_mode_pipe_mux_end_to_end(fake_ffmpeg_env, media_pair,
                                          tmp_path):
    """Stretch mode through the ffmpeg stdin-PCM pipe branch (the WAV-only
    builtin path is covered elsewhere; this exercises the mux contract of
    reference describealign.py:469-488)."""
    import describealign_jax as da
    from describealign_jax.media.decode import parse_audio_int16

    video_file, audio_file = media_pair
    out_dir, plot_dir = str(tmp_path / "out2"), str(tmp_path / "plots2")
    da.combine([video_file], [audio_file], yes=True, stretch_audio=True,
               output_dir=out_dir, alignment_dir=plot_dir)

    out_file = os.path.join(out_dir, "ad_episode_1.mp4")
    assert os.path.exists(out_file)
    args = json.load(open(out_file + ".ffargs.json"))
    assert 'pipe:' in args
    assert args[args.index('-c:a:0') + 1] == 'aac'
    assert args[args.index('-disposition:a:0') + 1] == \
        'default+visual_impaired+descriptions'
    # original first track gets renamed (fake probe reports no AD track)
    assert args[args.index('-disposition:a:1') + 1] == 'original'
    assert args[args.index('-max_interleave_delta') + 1] == '0'
    # piped PCM landed in the output, same length as the video
    video_pcm = parse_audio_int16(video_file, 2)
    out_pcm = parse_audio_int16(out_file, 2)
    assert out_pcm.shape == video_pcm.shape
