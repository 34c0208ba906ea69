"""Headless tests for the GUI logic layer (no wx required)."""
import multiprocessing
import os

import numpy as np
import pytest

from describealign_jax.gui import core


# --- transcript / progress-line state machine --------------------------------

def test_plain_lines_append():
    m = core.TranscriptModel()
    ops = m.feed("hello\n") + m.feed("world\n")
    assert [o.kind for o in ops] == ["append", "append"]
    assert m.text() == "hello\nworld"


def test_print_style_split_chunks_merge():
    # print("abc") arrives as two writes: "abc" then "\n"
    m = core.TranscriptModel()
    m.feed("abc")
    m.feed("\n")
    m.feed("def")
    m.feed("\n")
    assert m.text() == "abc\ndef"


def test_carriage_return_overwrites_last_line():
    m = core.TranscriptModel()
    m.feed("  matching audio...  \r")
    ops = m.feed("  refining match: pass 1 of 2...\r")
    assert ops[0].kind == "replace_last"
    ops = m.feed("done\n")
    assert ops[0].kind == "replace_last"
    assert m.text() == "done"


def test_blank_lines_preserved():
    m = core.TranscriptModel()
    m.feed("a\n")
    m.feed("\n")
    m.feed("b\n")
    assert m.text() == "a\n\nb"


def test_severity_classification():
    assert core.classify_line("  WARNING: similarity 12%") == "warning"
    assert core.classify_line("  ERROR: processing failed") == "error"
    assert core.classify_line("WARNING: not indented") is None
    assert core.classify_line("reading media files...") is None
    m = core.TranscriptModel()
    ops = m.feed("  WARNING: check inputs\n")
    assert ops[0].tag == "warning"


def test_partial_line_grows_in_place():
    m = core.TranscriptModel()
    m.feed("loading ")
    ops = m.feed("done")
    assert ops[0].kind == "replace_last"
    assert m.text() == "loading done"


# --- queue writer / child process --------------------------------------------

def test_queue_writer_forwards_chunks():
    import queue
    q = queue.Queue()
    w = core.QueueWriter(q)
    print("hello", file=w)
    w.write("")  # empty writes are dropped
    got = []
    while not q.empty():
        got.append(q.get())
    assert "".join(got) == "hello\n"


def test_run_combine_to_queue_reports_errors():
    import queue
    q = queue.Queue()
    settings = dict(stretch_audio=False, prepend="ad_",
                    no_pitch_correction=False, output_dir="/nonexistent",
                    alignment_dir="/nonexistent")
    # empty inputs make combine raise quickly; the wrapper must surface it
    core.run_combine_to_queue(q, ["/no/such/file.mp4"], [], settings)
    out = []
    while not q.empty():
        out.append(q.get())
    text = "".join(out)
    assert "  ERROR: processing failed" in text
    assert "Traceback" in text


# --- settings model -----------------------------------------------------------

def test_settings_model_round_trip(tmp_path):
    path = tmp_path / "config.ini"
    m = core.SettingsModel(path)
    assert m.values["prepend"] == "ad_"
    assert m.field_enabled("no_pitch_correction") is False  # gated
    m.set("stretch_audio", True)
    assert m.field_enabled("no_pitch_correction") is True
    m.set("prepend", "x_")
    m.save()
    m2 = core.SettingsModel(path)
    assert m2.values["stretch_audio"] is True
    assert m2.values["prepend"] == "x_"
    with pytest.raises(KeyError):
        m.set("bogus", 1)


def test_settings_schema_covers_combine_kwargs():
    keys = {f["key"] for f in core.SETTINGS_FIELDS}
    assert keys == {"stretch_audio", "no_pitch_correction", "prepend",
                    "output_dir", "alignment_dir"}


# --- file list helpers ---------------------------------------------------------

def test_expand_paths_filters_sorts_and_walks_dirs(tmp_path):
    d = tmp_path / "season"
    d.mkdir()
    names = ["ep10.mp4", "ep2.mp4", "ep1.mp4", "notes.txt"]
    for n in names:
        (d / n).write_bytes(b"x")
    loose = tmp_path / "bonus.mkv"
    loose.write_bytes(b"x")
    got = core.expand_paths([str(d), str(loose), str(tmp_path / "no.txt")],
                            {"mp4", "mkv"})
    assert [os.path.basename(p) for p in got] == \
        ["bonus.mkv", "ep1.mp4", "ep2.mp4", "ep10.mp4"]


def test_validate_selection_messages():
    assert core.validate_selection([], []) is not None
    assert core.validate_selection(["v"], []) is not None
    assert core.validate_selection([], ["a"]) is not None
    assert "counts differ" in core.validate_selection(["v1", "v2"], ["a1"])
    assert core.validate_selection(["v"], ["a"]) is None


def test_wildcard_string():
    w = core.wildcard_for({"mp3", "wav"}, "Audio files")
    assert w.startswith("Audio files (*.mp3;*.wav)|*.mp3;*.wav")
