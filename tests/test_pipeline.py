"""End-to-end combine() on WAV files (ffmpeg-free path) + CLI surface."""
import os

import numpy as np
import pytest

from describealign_jax.media.decode import parse_audio_from_file, write_wav
from tests.synth import build_pair


@pytest.fixture(scope="module")
def wav_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("media")
    video, audio, segments = build_pair(content_seconds=40.0, narration=(),
                                        lead_in=6.0, seed=3, channels=2)
    video_wav = tmp / "episode_1.wav"
    audio_wav = tmp / "described_1.wav"
    write_wav(video_wav, video)
    write_wav(audio_wav, audio)
    return str(video_wav), str(audio_wav), segments


def test_combine_stretch_wav_end_to_end(wav_pair, tmp_path):
    import describealign_jax as da
    video_wav, audio_wav, segments = wav_pair
    out_dir = str(tmp_path / "out")
    plot_dir = str(tmp_path / "plots")
    da.combine([video_wav], [audio_wav], stretch_audio=True, yes=True,
               output_dir=out_dir, alignment_dir=plot_dir)
    out_file = os.path.join(out_dir, "ad_episode_1.wav")
    assert os.path.exists(out_file)
    out_pcm = parse_audio_from_file(out_file, 2)
    video_pcm = parse_audio_from_file(video_wav, 2)
    assert out_pcm.shape == video_pcm.shape
    # the 6s lead-in region of the video should now carry replaced audio
    # that correlates with the (shifted) description, i.e. differs from the
    # original video track
    assert not np.allclose(out_pcm[:, :44100], video_pcm[:, :44100])
    # report artifacts
    assert os.path.exists(os.path.join(plot_dir, "episode_1.png"))
    report = open(os.path.join(plot_dir, "episode_1.txt")).read()
    assert "Input file similarity" in report
    assert "Start Offset:" in report
    assert "Median Rate Change:" in report


def test_combine_resume_skips_existing(wav_pair, tmp_path, capsys):
    import describealign_jax as da
    video_wav, audio_wav, _ = wav_pair
    out_dir = str(tmp_path / "out2")
    os.makedirs(out_dir)
    out_file = os.path.join(out_dir, "ad_episode_1.wav")
    with open(out_file, 'wb') as f:
        f.write(b'\0' * 200000)  # > 1e5 bytes: treated as done
    da.combine([video_wav], [audio_wav], stretch_audio=True, yes=True,
               output_dir=out_dir, alignment_dir=str(tmp_path / "p2"))
    assert "output file already exists, skipping..." in capsys.readouterr().out
    assert os.path.getsize(out_file) == 200000  # untouched


def test_combine_requires_stretch_for_audio_pairs(wav_pair, tmp_path):
    import describealign_jax as da
    video_wav, audio_wav, _ = wav_pair
    with pytest.raises(RuntimeError, match="ffmpeg|stretch_audio"):
        da.combine([video_wav], [audio_wav], stretch_audio=False, yes=True,
                   output_dir=str(tmp_path / "o"),
                   alignment_dir=str(tmp_path / "p"))


def test_cli_version(capsys):
    from describealign_jax.cli import command_line_interface
    command_line_interface(['--version'])
    out = capsys.readouterr().out
    assert "version:" in out
    assert "content hash:" in out


def test_cli_version_provenance_installed(capsys):
    """find_spec resolves to this package -> 'installed package'
    (reference describealign.py:1820-1840)."""
    from describealign_jax.cli import command_line_interface
    command_line_interface(['--version'])
    assert "running from installed package" in capsys.readouterr().out


def test_cli_version_provenance_downloaded(capsys, monkeypatch):
    """A package that isn't the find_spec-resolved one -> 'downloaded'."""
    import importlib.util
    from describealign_jax.cli import command_line_interface
    monkeypatch.setattr(importlib.util, 'find_spec', lambda name: None)
    command_line_interface(['--version'])
    assert "running from downloaded .py file" in capsys.readouterr().out


def test_cli_version_provenance_compiled(capsys, monkeypatch):
    """PyInstaller-style frozen interpreter -> 'compiled binary'."""
    import sys as _sys
    from describealign_jax.cli import command_line_interface
    monkeypatch.setattr(_sys, 'frozen', True, raising=False)
    command_line_interface(['--version'])
    out = capsys.readouterr().out
    assert "running from compiled binary" in out
    assert "content hash:" not in out


def test_cli_warmup_compiles_buckets(capsys):
    """--warmup MIN pre-compiles every bucket a MIN-minute file can hit,
    including the fused batch-transport program the multi-pair combine()
    path dispatches (api.warmup_compile)."""
    from describealign_jax.cli import command_line_interface
    command_line_interface(['--warmup', '1'])
    out = capsys.readouterr().out
    assert "compiling bucket" in out
    assert "warmed 1 shape buckets." in out


def test_alignment_cache_reused(wav_pair, tmp_path, capsys, monkeypatch):
    """Second run with a fresh output dir must reuse the cached alignment."""
    import describealign_jax as da
    video_wav, audio_wav, _ = wav_pair
    plot_dir = str(tmp_path / "plots")
    da.combine([video_wav], [audio_wav], stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "o1"), alignment_dir=plot_dir)
    capsys.readouterr()
    import describealign_jax.alignment.api as api_mod

    def boom(*a, **k):
        raise AssertionError("align() should not run on a cache hit")

    monkeypatch.setattr(api_mod, 'align', boom)
    da.combine([video_wav], [audio_wav], stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "o2"), alignment_dir=plot_dir)
    assert os.path.exists(os.path.join(str(tmp_path / "o2"),
                                       "ad_episode_1.wav"))


def test_combine_no_pitch_correction(wav_pair, tmp_path):
    """BASELINE config 4: raw-resample stretch (--no_pitch_correction)."""
    import describealign_jax as da
    video_wav, audio_wav, _ = wav_pair
    out_dir = str(tmp_path / "out_np")
    da.combine([video_wav], [audio_wav], stretch_audio=True, yes=True,
               no_pitch_correction=True, output_dir=out_dir,
               alignment_dir=str(tmp_path / "plots_np"))
    out_file = os.path.join(out_dir, "ad_episode_1.wav")
    assert os.path.exists(out_file)
    out_pcm = parse_audio_from_file(out_file, 2)
    assert np.sqrt(np.mean(out_pcm.astype(np.float64) ** 2)) > 100


def test_combine_directory_mode_two_pairs(tmp_path):
    """Directory inputs: natural-sort pairing, decode-ahead loop, two
    outputs (reference combine's batch behavior, describealign.py:1077)."""
    import describealign_jax as da
    vids = tmp_path / "vids"
    auds = tmp_path / "auds"
    vids.mkdir()
    auds.mkdir()
    for idx, seed in ((1, 3), (2, 11)):
        video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                     lead_in=6.0, seed=seed, channels=2)
        write_wav(vids / f"show_ep{idx}.wav", video)
        write_wav(auds / f"show_ep{idx}_described.wav", audio)
    out_dir = str(tmp_path / "out")
    da.combine(str(vids), str(auds), stretch_audio=True, yes=True,
               output_dir=out_dir, alignment_dir=str(tmp_path / "plots"))
    assert os.path.exists(os.path.join(out_dir, "ad_show_ep1.wav"))
    assert os.path.exists(os.path.join(out_dir, "ad_show_ep2.wav"))
    assert os.path.exists(str(tmp_path / "plots" / "show_ep1.txt"))
    assert os.path.exists(str(tmp_path / "plots" / "show_ep2.txt"))


def test_combine_stage_progress_lines(wav_pair, tmp_path, capsys,
                                      monkeypatch):
    """Sequential per-pair runs print the reference's per-stage progress
    line sequence (describealign.py:1097-1113 + align's own lines)."""
    import describealign_jax as da
    monkeypatch.setenv('DESCRIBEALIGN_BATCH', '0')
    video_wav, audio_wav, _ = wav_pair
    da.combine([video_wav], [audio_wav], stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "out"),
               alignment_dir=str(tmp_path / "plots"))
    out = capsys.readouterr().out
    stages = ["  reading video file...\r",
              "  computing video features... \r",
              "  reading audio file...       \r",
              "  computing audio features...\r",
              "  memorizing video...        \r",
              "  matching audio...  \r",
              "  refining match: pass 1 of 2...\r",
              "  refining match: pass 2 of 2...\r",
              "  processing output file..."]
    pos = -1
    for line in stages:
        nxt = out.find(line)
        assert nxt > pos, f"stage line missing or out of order: {line!r}"
        pos = nxt


@pytest.fixture()
def wav_three_pair_dirs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("batchmedia")
    vids = tmp / "vids"
    auds = tmp / "auds"
    vids.mkdir()
    auds.mkdir()
    for idx, seed in ((1, 3), (2, 11), (3, 23)):
        video, audio, _ = build_pair(content_seconds=40.0, narration=(),
                                     lead_in=6.0, seed=seed, channels=2)
        write_wav(vids / f"show_ep{idx}.wav", video)
        write_wav(auds / f"show_ep{idx}_described.wav", audio)
    return str(vids), str(auds)


def test_combine_directory_batched_matches_sequential(wav_three_pair_dirs,
                                                      tmp_path, monkeypatch):
    """Multi-pair directory mode routes through align_batch_from_pcm (the
    pipelined batch replacement for the reference's sequential loop,
    describealign.py:1077) and produces byte-identical reports vs the
    sequential path (DESCRIBEALIGN_BATCH=0)."""
    import describealign_jax as da
    import describealign_jax.alignment.api as api_mod
    vids, auds = wav_three_pair_dirs

    calls = {"batch": 0, "single": 0}
    real_batch = api_mod.align_batch_from_pcm
    real_single = api_mod.align_from_pcm

    def count_batch(*a, **k):
        calls["batch"] += 1
        return real_batch(*a, **k)

    def count_single(*a, **k):
        calls["single"] += 1
        return real_single(*a, **k)

    monkeypatch.setattr(api_mod, 'align_batch_from_pcm', count_batch)
    monkeypatch.setattr(api_mod, 'align_from_pcm', count_single)

    monkeypatch.setenv('DESCRIBEALIGN_BATCH', '0')
    da.combine(vids, auds, stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "out_seq"),
               alignment_dir=str(tmp_path / "plots_seq"))
    assert calls == {"batch": 0, "single": 3}

    monkeypatch.delenv('DESCRIBEALIGN_BATCH')
    da.combine(vids, auds, stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "out_bat"),
               alignment_dir=str(tmp_path / "plots_bat"))
    assert calls["batch"] >= 1 and calls["single"] == 3

    for idx in (1, 2, 3):
        seq = open(tmp_path / "plots_seq" / f"show_ep{idx}.txt").read()
        bat = open(tmp_path / "plots_bat" / f"show_ep{idx}.txt").read()
        # the embedded ffmpeg command carries the output dir; normalize it
        assert (bat.replace("out_bat", "out_seq")
                == seq), f"report mismatch for pair {idx}"
        out_seq = parse_audio_from_file(
            str(tmp_path / "out_seq" / f"ad_show_ep{idx}.wav"), 2)
        out_bat = parse_audio_from_file(
            str(tmp_path / "out_bat" / f"ad_show_ep{idx}.wav"), 2)
        assert np.array_equal(out_seq, out_bat)


def test_combine_batched_skip_and_cache_interleave(wav_three_pair_dirs,
                                                   tmp_path, monkeypatch,
                                                   capsys):
    """Batched directory mode preserves skip/resume and cached-alignment
    semantics for interleaved pairs."""
    import describealign_jax as da
    vids, auds = wav_three_pair_dirs
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    plots = str(tmp_path / "plots")
    # pair 2's output pre-exists (resume skip)
    with open(out_dir / "ad_show_ep2.wav", 'wb') as f:
        f.write(b'\0' * 200000)
    da.combine(vids, auds, stretch_audio=True, yes=True,
               output_dir=str(out_dir), alignment_dir=plots)
    out = capsys.readouterr().out
    assert "output file already exists, skipping..." in out
    assert os.path.getsize(out_dir / "ad_show_ep2.wav") == 200000
    assert os.path.exists(out_dir / "ad_show_ep1.wav")
    assert os.path.exists(out_dir / "ad_show_ep3.wav")

    # second run into a fresh output dir: pairs 1/3 hit the alignment
    # cache, pair 2 aligns for the first time - align() must not run for
    # the cached ones (cache-hit semantics survive batching)
    import describealign_jax.alignment.api as api_mod
    real_batch = api_mod.align_batch_from_pcm
    real_single = api_mod.align_from_pcm
    seen = {"batch_pairs": 0, "single": 0}

    def spy_batch(pairs, *a, **k):
        seen["batch_pairs"] += len(pairs)
        return real_batch(pairs, *a, **k)

    def spy_single(*a, **k):
        seen["single"] += 1
        return real_single(*a, **k)

    monkeypatch.setattr(api_mod, 'align_batch_from_pcm', spy_batch)
    monkeypatch.setattr(api_mod, 'align_from_pcm', spy_single)
    da.combine(vids, auds, stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "out2"), alignment_dir=plots)
    # only pair 2 needed alignment; a single work pair stays sequential
    assert seen == {"batch_pairs": 0, "single": 1}
    for idx in (1, 2, 3):
        assert os.path.exists(tmp_path / "out2" / f"ad_show_ep{idx}.wav")


def test_combine_directory_mesh_matches_batched(wav_three_pair_dirs,
                                                tmp_path, monkeypatch):
    """DESCRIBEALIGN_MESH routes directory batches through the
    mesh-sharded matcher (api._align_batch_sharded, one pair per device
    over the virtual CPU mesh) with byte-identical reports vs the
    single-device batch path - the product wiring for multi-chip hosts."""
    import describealign_jax as da
    import describealign_jax.alignment.api as api_mod
    vids, auds = wav_three_pair_dirs

    calls = {"sharded": 0}
    real_sharded = api_mod._align_batch_sharded

    def spy_sharded(pairs, *a, **k):
        calls["sharded"] += len(pairs)
        return real_sharded(pairs, *a, **k)

    monkeypatch.setattr(api_mod, '_align_batch_sharded', spy_sharded)

    da.combine(vids, auds, stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "out_bat"),
               alignment_dir=str(tmp_path / "plots_bat"))
    assert calls["sharded"] == 0

    # force2: CPU backends are excluded from auto-mesh (virtual devices
    # share the host cores), so the test opts in with a 2-device cap to
    # bound compile time
    monkeypatch.setenv('DESCRIBEALIGN_MESH', 'force2')
    da.combine(vids, auds, stretch_audio=True, yes=True,
               output_dir=str(tmp_path / "out_mesh"),
               alignment_dir=str(tmp_path / "plots_mesh"))
    assert calls["sharded"] == 3

    for idx in (1, 2, 3):
        bat = open(tmp_path / "plots_bat" / f"show_ep{idx}.txt").read()
        mesh = open(tmp_path / "plots_mesh" / f"show_ep{idx}.txt").read()
        assert (mesh.replace("out_mesh", "out_bat")
                == bat), f"report mismatch for pair {idx}"
        out_bat = parse_audio_from_file(
            str(tmp_path / "out_bat" / f"ad_show_ep{idx}.wav"), 2)
        out_mesh = parse_audio_from_file(
            str(tmp_path / "out_mesh" / f"ad_show_ep{idx}.wav"), 2)
        assert np.array_equal(out_bat, out_mesh)
