"""Host-side media/utility contract tests (no ffmpeg needed)."""
import numpy as np
import pytest

from describealign_jax.media.mux import encode_fit_as_ffmpeg_expr
from describealign_jax.utils.files import get_sorted_filenames
from describealign_jax.utils.sorting import os_sorted


def test_setts_expression_format():
    """Exact reference formatting (describealign.py:419-435): one clip()
    term per segment, 4-decimal times, 9-decimal slope deltas."""
    audio_times = np.array([0.0, 10.0, 25.0])
    video_times = np.array([5.0, 15.0, 30.123456])
    expr = encode_fit_as_ffmpeg_expr(audio_times, video_times, video_offset=5.0)
    assert expr.startswith('TS+(0')
    assert expr.endswith(')')
    # segment 1: y0=5, offset 5 -> clip from 0.0000, height dy=10
    assert '+clip(TS-0.0000/TB,0,10.0000/TB)*' in expr
    # slope of segment 1: dx/dy = 10/10 = 1 -> slope-1 = 0.000000000
    assert '*0.000000000' in expr
    # segment 2: y1=15 -> starts at 10.0000, dy=15.123456 -> 15.1235
    assert '+clip(TS-10.0000/TB,0,15.1235/TB)*' in expr
    seg2_slope = (25.0 - 10.0) / (30.123456 - 15.0) - 1
    assert f'*{seg2_slope:.9f}' in expr


def test_setts_expression_negative_dy_clamped():
    expr = encode_fit_as_ffmpeg_expr(np.array([0., 1., 2.]),
                                     np.array([0., -1., 2.]), 0.0)
    assert ',0,0.0000/TB)' in expr  # max(0, dy) like the reference


def test_natural_sort_order():
    files = ['ep10.mp4', 'ep2.mp4', 'Ep1.mp4', 'ep2b.mp4']
    assert os_sorted(files) == ['Ep1.mp4', 'ep2.mp4', 'ep2b.mp4', 'ep10.mp4']


def test_natural_sort_case_insensitive():
    """natsort's os_sorted fallback casefolds (ns.IGNORECASE); ASCII-order
    keys would mis-pair ['B.mp4','a.mp4'] against ['b.mp3','a.mp3']."""
    assert os_sorted(['B.mp4', 'a.mp4']) == ['a.mp4', 'B.mp4']
    assert os_sorted(['b.mp3', 'a.mp3']) == ['a.mp3', 'b.mp3']


def test_natural_sort_extension_split():
    """ns.PATH splits the final extension off, so a base-name prefix wins
    regardless of how the extension compares to the next character
    ('a.mkv' < 'a 1.mp4' even though '.' > ' ' bytewise)."""
    assert os_sorted(['a 1.mp4', 'a.mkv']) == ['a.mkv', 'a 1.mp4']
    # consistent with the matching audio side (same comparator -> same
    # relative order -> correct pairing)
    assert os_sorted(['a 1.mp3', 'a.mp3']) == ['a.mp3', 'a 1.mp3']


def test_natural_sort_multi_and_numeric_extensions():
    """Extensions peel one at a time, stopping at numeric suffixes
    (natsort path_splitter's \\.\\d rule): 'file.2.txt' keeps 'file.2'."""
    assert os_sorted(['file.10.txt', 'file.2.txt']) == \
        ['file.2.txt', 'file.10.txt']
    assert os_sorted(['x.tar.gz', 'x.tar']) == ['x.tar', 'x.tar.gz']


def test_natural_sort_digits_before_letters():
    """Keys start with a string chunk ('' before digits), so digit-leading
    names sort before letter-leading ones - natsort's documented order."""
    assert os_sorted(['foo.mp4', '1foo.mp4']) == ['1foo.mp4', 'foo.mp4']


def test_natural_sort_unicode_nfd_equivalence():
    """Composed and decomposed forms of the same text sort adjacently
    (NFD normalization), not split apart by a byte-order artifact."""
    composed = 'épisode2.mp4'       # é as one codepoint
    decomposed = 'épisode2.mp4'    # e + combining acute
    out = os_sorted(['zz.mp4', composed, decomposed, 'aa.mp4'])
    assert out[0] == 'aa.mp4' and out[-1] == 'zz.mp4'
    assert set(out[1:3]) == {composed, decomposed}


def test_natural_sort_path_components():
    """Directories compare component-wise: 'dir2/x' < 'dir10/x'."""
    assert os_sorted(['dir10/x.mp4', 'dir2/x.mp4']) == \
        ['dir2/x.mp4', 'dir10/x.mp4']


def test_natural_sort_pairing_consistency():
    """The property that actually protects users: a video list and its
    description list sort into the same relative order, including the
    adversarial mixed-extension + mixed-case shapes above."""
    vids = ['Show ep10.mkv', 'show EP2.mp4', 'show ep1.mp4', 'Show.mp4']
    auds = ['Show ep10.mp3', 'show EP2.flac', 'show ep1.mp3', 'Show.wav']
    sv = [f.rsplit('.', 1)[0].casefold() for f in os_sorted(vids)]
    sa = [f.rsplit('.', 1)[0].casefold() for f in os_sorted(auds)]
    assert sv == sa == ['show', 'show ep1', 'show ep2', 'show ep10']


def test_get_sorted_filenames_pairs_and_alt_flags(tmp_path):
    for name in ['b2.mp4', 'b10.mp4', 'b1.mp3', 'notes.txt']:
        (tmp_path / name).write_bytes(b'x')
    files, alt = get_sorted_filenames(str(tmp_path), {'mp4'}, {'mp3'})
    names = [f.split('/')[-1] for f in files]
    assert names == ['b1.mp3', 'b2.mp4', 'b10.mp4']
    assert alt == [1, 0, 0]


def test_get_sorted_filenames_errors(tmp_path):
    with pytest.raises(RuntimeError, match="No file or directory"):
        get_sorted_filenames(str(tmp_path / "nope.mp4"), {'mp4'})
    (tmp_path / "a.txt").write_bytes(b'x')
    with pytest.raises(RuntimeError, match="valid extensions"):
        get_sorted_filenames(str(tmp_path), {'mp4'})


def test_mux_default_mode_command(monkeypatch, tmp_path):
    """Video-retime mux: itsoffset/ss placement, setts bsf on video AND
    subtitles, dispositions, frag_keyframe - the reference's exact contract
    (describealign.py:489-510)."""
    from describealign_jax.media import mux

    calls = {}

    def fake_run(args, err_msg, stdin_bytes=None):
        calls['args'] = list(args)
        calls['stdin'] = stdin_bytes
        return b'', b''

    monkeypatch.setattr(mux, 'run_ffmpeg_command', fake_run)
    monkeypatch.setattr(mux, 'compile_command_line',
                        lambda args: 'ffmpeg ' + ' '.join(args))
    cmd = mux.write_replaced_media_to_disk(
        str(tmp_path / 'out.mp4'), None, video_file='in.mp4',
        audio_desc_file='ad.mp3', setts_cmd='TS+(0)', video_offset=10.0,
        after_start_key_frame=8.5, median_slope=1.02)
    a = calls['args']
    # audio input shifted by start_offset = 10 - 8.5
    i_audio = a.index('ad.mp3')
    assert a[i_audio - 1] == '-i' and a[a.index('-itsoffset')] == '-itsoffset'
    assert '1.500000' in a[a.index('-itsoffset') + 1]
    # video cut at the keyframe midpoint, audio-stripped, data-stripped
    assert '-ss' in a and a[a.index('-ss') + 1] == '8.500000'
    assert '-an' in a and '-dn' in a
    # setts on video and subtitles; subtitle durations scaled by 1/slope
    bsf_v = a[a.index('-bsf:v') + 1]
    assert bsf_v == "setts=pts='TS+(0)':dts='TS+(0)'"
    bsf_s = a[a.index('-bsf:s') + 1]
    assert bsf_s.startswith("setts=ts='TS+(0)'")
    assert f":duration='DURATION*{1/1.02:.6f}'" in bsf_s
    # dispositions, fragmentation, mkv workaround
    assert a[a.index('-disposition:a:0') + 1] == \
        'default+visual_impaired+descriptions'
    assert a[a.index('-metadata:s:a:0') + 1] == 'title=AD'
    assert a[a.index('-movflags') + 1] == 'frag_keyframe'
    assert a[a.index('-max_interleave_delta') + 1] == '0'
    assert cmd.startswith('ffmpeg ')


def test_mux_stretch_mode_command(monkeypatch, tmp_path):
    """Stretch-mode mux: PCM piped on stdin as the new default AAC track,
    original tracks stream-copied, track renaming (reference 469-488)."""
    from describealign_jax.media import mux

    calls = {}

    def fake_run(args, err_msg, stdin_bytes=None):
        calls['args'] = list(args)
        calls['stdin'] = stdin_bytes
        return b'', b''

    monkeypatch.setattr(mux, 'run_ffmpeg_command', fake_run)
    monkeypatch.setattr(mux, 'compile_command_line',
                        lambda args: 'ffmpeg ' + ' '.join(args))
    monkeypatch.setattr(mux, 'is_first_video_track_ad', lambda f: False)
    pcm = np.zeros((2, 1000), np.float32)
    mux.write_replaced_media_to_disk(str(tmp_path / 'out.mkv'), pcm,
                                     video_file='in.mkv')
    a = calls['args']
    assert a[a.index('-i') + 1] == 'pipe:'
    assert calls['stdin'] == pcm.astype(np.int16).T.tobytes()
    assert a[a.index('-c:a:0') + 1] == 'aac'
    # output codecs (the first -acodec is the pipe input's pcm_s16le)
    out_start = a.index('in.mkv')
    assert a[a.index('-acodec', out_start) + 1] == 'copy'
    assert a[a.index('-vcodec', out_start) + 1] == 'copy'
    assert a[a.index('-scodec', out_start) + 1] == 'copy'
    # first track isn't AD: original track gets renamed
    assert a[a.index('-disposition:a:1') + 1] == 'original'
    assert a[a.index('-metadata:s:a:1') + 1] == 'title=original'


def test_cli_no_args_without_gui(capsys):
    """No args + no wxPython: explain, then print usage (reference 1788)."""
    from describealign_jax.cli import command_line_interface
    command_line_interface([])
    out = capsys.readouterr().out
    assert "GUI dependencies missing" in out
