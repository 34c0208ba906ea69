#!/usr/bin/env python3
"""Smoke test of the alignment pipeline on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
size users run: a 22-min video against a ~27-min description track
(bench.build_scale_pair) and a directory batch of eight such pairs
(bench.build_batch_pairs), all generated from seeds. Phases, in order:

  a. the card (nvidia-smi name and power limit), JAX's devices and version,
     and whether the native C++ host library built;
  b. the matcher compiled at the 22-min shape bucket, with its
     memory_analysis();
  c. the GPU against a plain reference at real width: the same jitted
     functions on the CPU device in this process, full f32. Coarse tracks
     must be equal, fine candidate sets agree within FINE_* below, the final
     fit nodes within NODE_TOL_S; device features against the host C++
     features on the same PCM;
  d. align_from_pcm on the 22-min pair against its planted truth, with the
     first-call and best-of-3 warm wall times;
  e. align_batch_from_pcm on the eight pairs against their planted truths,
     with audio-minutes per second;
  f. the CLI (`python -m describealign_jax v.wav a.wav --stretch_audio
     --yes`, called in this process so one process holds the card) on a WAV
     pair: the output WAV and the .txt report must appear, and the .png
     where matplotlib is installed.

With --four-cards it runs only the directory batch on a four-device mesh
(what pipeline._auto_mesh picks on such a host) against the same batch
unsharded on one card, and checks that all four cards did work.

Any failed check raises, so the script exits non-zero; it exits non-zero
before any phase when JAX's default backend is not a GPU. The last line of
standard output is one JSON object naming the device.

    python3 chip_smoke.py [--four-cards]
"""
import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

FS = 210                      # feature frames per second
SR = 44100
# fine-pass agreement between the GPU and the CPU reference (both full
# f32): summation order differs, so a candidate whose quality sits on a
# gate or a top-K boundary may flip; the rest agree to f32 rounding
# carried through 1 - corr near 1 and the ^2.9, ^(-1/3) powers
FINE_SET_DIFF_MAX = 1e-4      # symmetric set difference / candidates
FINE_QUAL_RTOL_P99 = 1e-3     # 99th percentile of |q_gpu - q_cpu| / q_cpu
NODE_TOL_S = 1.0 / FS         # fit nodes within one feature frame
FEATURE_RTOL, FEATURE_ATOL = 1e-4, 1e-5


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise CheckFailed(what)


def result_line(platform, kind, count):
    """The script's last line: exactly the keys the contract names."""
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def require_gpu():
    """Exit non-zero, before any phase, unless JAX's default backend is a
    GPU: a run on another backend measures a different program."""
    import jax
    backend = jax.default_backend()
    if backend != 'gpu':
        print(f"chip_smoke: needs a GPU; JAX's default backend is "
              f"{backend!r}", file=sys.stderr)
        sys.exit(2)
    return jax.devices()


def phase(name):
    print(f"\n== {name}", flush=True)
    return time.time()


def done(t0):
    print(f"  phase wall {time.time() - t0:.3f} s", flush=True)


def to_i16(x):
    return np.clip(np.round(x), -32768, 32767).astype(np.int16)


def scale_pair():
    import bench
    from describealign_jax.alignment.api import _pad_pcm_i16
    video, audio, _ = bench.build_scale_pair()
    video, audio = to_i16(video), to_i16(audio)
    return (_pad_pcm_i16(video), _pad_pcm_i16(audio),
            video.shape[1], audio.shape[1])


# --- phase a -----------------------------------------------------------------

def phase_card(devices):
    t0 = phase("a. card")
    import bench
    import jax

    from describealign_jax.alignment.native import native_lib
    for line in bench.gpu_identity()['nvidia_smi']:
        print(f"  nvidia-smi: {line}")
    print(f"  jax {jax.__version__}, devices {devices}")
    print(f"  device_kind {devices[0].device_kind!r}, "
          f"default backend {jax.default_backend()!r}")
    lib = native_lib()
    print(f"  native host library: {'loaded' if lib else 'MISSING'}")
    check(lib is not None, "native C++ host library built and loaded")
    done(t0)


# --- phase b -----------------------------------------------------------------

def phase_compile(npad):
    t0 = phase(f"b. compile the matcher at the {npad}-frame bucket")
    import jax

    from describealign_jax.alignment import matching
    feats = jax.ShapeDtypeStruct((5, npad), np.float16)
    n = jax.ShapeDtypeStruct((), np.int32)
    coarse = matching.match_coarse.lower(feats, n, feats, n).compile()
    state = jax.eval_shape(matching.match_coarse, feats, n, feats, n)
    fine = matching.match_fine_chunk.lower(*state[:7], n, n).compile()
    for name, comp in (("match_coarse", coarse),
                       ("match_fine_chunk", fine)):
        print(f"  {name}: {comp.memory_analysis()}")
    done(t0)


# --- phase c -----------------------------------------------------------------

def _fine_all(ms_a, norms_a, a_mask, ms_v, norms_v, v_mask, starts_tracks,
              nb):
    """Unquantized f32 fine-pass candidates for every block."""
    from describealign_jax.alignment import matching
    return matching._fine_tracks(ms_a, norms_a, a_mask, ms_v, norms_v,
                                 v_mask, starts_tracks[:, :nb], 0, nb, nb)


def match_on(device, feats_a, na, feats_v, nv):
    """Coarse tracks, margin and f32 fine candidates of one pair, computed
    on `device` by the production jitted functions."""
    import jax

    from describealign_jax.alignment import matching
    put = lambda x: jax.device_put(x, device)  # noqa: E731
    state = matching.match_coarse(put(feats_a.astype(np.float16)), put(na),
                                  put(feats_v.astype(np.float16)), put(nv))
    nb = matching.nb_for(feats_a.shape[1])
    fine = jax.jit(_fine_all, static_argnums=7)(*state[:7], nb)
    quals, offs, starts = (np.asarray(x) for x in fine)
    return (np.asarray(state[6])[:, :nb], float(np.asarray(state[7])),
            quals, offs, starts)


def candidate_dict(quals, offs, starts):
    """{(block, frame, band, video frame): quality} over the live slots.
    Slot j starts at starts[:, j // (TOP_K // 2)]; band 1 holds the first
    TOP_K slots, each rescue band the next TOP_K // 2."""
    from describealign_jax.alignment import matching
    k1, half = matching.TOP_K, matching.TOP_K // 2
    b, l, k = np.nonzero(quals > 0)
    vid = starts[b, k // half] + offs[b, l, k]
    band = np.where(k < k1, 0, 1 + (k - k1) // half)
    return dict(zip(zip(b.tolist(), l.tolist(), band.tolist(),
                        vid.tolist()), quals[b, l, k].tolist()))


def nodes_of(margin, quals, offs, starts, fa, fv, na, nv):
    """Fit nodes from one device's candidates through the production host
    stages (the margin drives the low-confidence retry, as in production)."""
    from describealign_jax.alignment import api
    r = api._host_stages(quals, offs, starts, fa, fv, na, nv, 'native',
                         quiet=True, margin=margin)
    return np.asarray(r[0]), np.asarray(r[1])


def phase_reference(video, audio, sv, sa, gpu):
    t0 = phase("c. GPU against the CPU reference at real width")
    import jax

    from describealign_jax.alignment import api, matching
    from describealign_jax.ops.features import extract_features
    cpu = jax.devices('cpu')[0]
    print(f"  precision: {matching.MATMUL_PRECISION} on both devices; "
          f"reference device {cpu}")
    npad = max(api._bucket_pad(sv // FS), api._bucket_pad(sa // FS))
    fv, nv = api.host_features_padded(video, sv, npad)
    fa, na = api.host_features_padded(audio, sa, npad)
    # the reference sees the f16 grid the device sees
    fa = fa.astype(np.float16).astype(np.float32)
    fv = fv.astype(np.float16).astype(np.float32)

    t = time.time()
    g = match_on(gpu, fa, na, fv, nv)
    print(f"  GPU matcher (incl. compile) {time.time() - t:.3f} s")
    t = time.time()
    c = match_on(cpu, fa, na, fv, nv)
    print(f"  CPU matcher (incl. compile) {time.time() - t:.3f} s")

    lanes_equal = np.array_equal(g[0], c[0])
    print(f"  coarse band starts {g[0].shape}: "
          f"{int(np.sum(g[0] != c[0]))} lanes differ; margin gpu "
          f"{g[1]:.6f} cpu {c[1]:.6f}")
    check(lanes_equal, "coarse tracks equal lane for lane")

    dg, dc = candidate_dict(*g[2:]), candidate_dict(*c[2:])
    diff = len(set(dg) ^ set(dc))
    shared = set(dg) & set(dc)
    rel = np.array([abs(dg[k] - dc[k]) / dc[k] for k in shared])
    print(f"  fine candidates: gpu {len(dg)}, cpu {len(dc)}, symmetric "
          f"difference {diff} ({diff / max(1, len(dc)):.2e}); quality "
          f"rel err p99 {np.percentile(rel, 99):.3e}, max {rel.max():.3e}")
    check(diff <= FINE_SET_DIFF_MAX * len(dc),
          f"fine candidate sets differ by <= {FINE_SET_DIFF_MAX:g}")
    check(np.percentile(rel, 99) <= FINE_QUAL_RTOL_P99,
          f"fine qualities agree, p99 rtol <= {FINE_QUAL_RTOL_P99:g}")

    xg, yg = nodes_of(*g[1:], fa, fv, na, nv)
    xc, yc = nodes_of(*c[1:], fa, fv, na, nv)
    same_len = len(xg) == len(xc)
    err = (max(np.max(np.abs(xg - xc)), np.max(np.abs(yg - yc)))
           if same_len else float('inf'))
    print(f"  fit nodes: gpu {len(xg)}, cpu {len(xc)}, max |diff| "
          f"{err:.3e} s")
    check(same_len and err <= NODE_TOL_S,
          f"fit nodes agree within {NODE_TOL_S:.6f} s")

    for name, pcm, n in (("video", video, sv), ("audio", audio, sa)):
        # the device extractor takes PCM on the float16 grid, as decode
        # stores it; the host extractor quantizes int16 the same way
        grid = pcm[:, :n].astype(np.float16).astype(np.float32)
        dev = [np.asarray(f) for f in extract_features(
            jax.device_put(grid, gpu))]
        host, nf = api.host_features_padded(pcm, n, npad)
        worst = 0.0
        for j, f in enumerate(dev):
            k = min(len(f), nf)
            excess = (np.abs(f[:k] - host[j, :k])
                      - FEATURE_RTOL * np.abs(host[j, :k]))
            worst = max(worst, float(np.max(excess)))
        print(f"  {name} features: device vs host C++, worst "
              f"|diff| - rtol*|host| = {worst:.3e}")
        check(worst <= FEATURE_ATOL,
              f"{name} device features match host within rtol "
              f"{FEATURE_RTOL:g}, atol {FEATURE_ATOL:g}")
    done(t0)


# --- phase d -----------------------------------------------------------------

def phase_single(video, audio, sv, sa):
    t0 = phase("d. align_from_pcm on the 22-min pair")
    from describealign_jax.alignment.api import align_from_pcm

    def run():
        t = time.time()
        r = align_from_pcm(video, audio, video_samples=sv, audio_samples=sa)
        return r, time.time() - t

    r, first = run()
    warm = [run()[1] for _ in range(3)]
    x, y, sim, _, slope = r[:5]
    offset = float(x[0] - y[0])
    print(f"\n  first call (incl. compile) {first:.3f} s; warm "
          f"{[round(w, 4) for w in warm]} s, best {min(warm):.4f} s")
    print(f"  start offset {offset:.4f} s, similarity {sim:.2f}%, "
          f"median slope {slope:.6f}, {len(x)} nodes")
    check(abs(offset - 202.0) <= 0.01, "start offset 202.00 +/- 0.01 s")
    check(sim > 90.0, "similarity > 90%")
    check(abs(slope - 1.0) <= 1e-3, "median slope 1.0")
    done(t0)


# --- phase e -----------------------------------------------------------------

def batch_pairs():
    import bench
    pairs, lens, planted, kinds = bench.build_batch_pairs()
    return pairs, [tuple(int(v) for v in t) for t in lens], planted, kinds


def check_batch(results, planted, kinds):
    for i, (r, p) in enumerate(zip(results, planted)):
        off = float(r[0][0] - r[1][0])
        print(f"  pair {i} ({kinds[i]}): offset {off:.3f} s (planted "
              f"{p:.1f}), similarity {float(r[2]):.2f}%, slope "
              f"{float(r[4]):.6f}")
        check(abs(off - p) < 1.0, f"pair {i} offset within 1 s")
    slope = float(results[kinds.index("rate")][4])
    check(abs(slope - 1 / 1.03) <= 1e-3, "rate pair slope 1/1.03 +/- 1e-3")
    sim = float(results[kinds.index("lowsim")][2])
    check(40.0 <= sim <= 60.0, "low-similarity pair at 40-60%")


def phase_batch():
    t0 = phase("e. align_batch_from_pcm on eight pairs")
    from describealign_jax.alignment.api import align_batch_from_pcm
    pairs, lens, planted, kinds = batch_pairs()
    print(f"  built 8 pairs in {time.time() - t0:.1f} s")
    t = time.time()
    align_batch_from_pcm(pairs, true_samples=lens)
    first = time.time() - t
    t = time.time()
    results = align_batch_from_pcm(pairs, true_samples=lens)
    warm = time.time() - t
    minutes = sum(a / SR / 60.0 for (_, a) in lens)
    print(f"\n  first call (incl. compile) {first:.3f} s; warm {warm:.4f} s "
          f"= {minutes / warm:.2f} audio-minutes/s over {minutes:.1f} min")
    check_batch(results, planted, kinds)
    done(t0)


# --- phase f -----------------------------------------------------------------

def phase_cli():
    t0 = phase("f. CLI stretch run on a WAV pair")
    import importlib.util

    from describealign_jax.cli import command_line_interface
    from describealign_jax.media.decode import write_wav
    from describealign_jax.utils.synthmedia import build_pair
    video, audio, _ = build_pair(content_seconds=150.0,
                                 narration=((50.0, 6.0), (100.0, 8.0)),
                                 lead_in=12.0, seed=7, channels=2)
    with tempfile.TemporaryDirectory() as d:
        v, a = os.path.join(d, 'v.wav'), os.path.join(d, 'a.wav')
        write_wav(v, video)
        write_wav(a, audio)
        out_dir, plot_dir = os.path.join(d, 'out'), os.path.join(d, 'plots')
        command_line_interface([v, a, '--stretch_audio', '--yes',
                                '--output_dir', out_dir,
                                '--alignment_dir', plot_dir])
        made = sorted(os.listdir(out_dir)) + sorted(os.listdir(plot_dir))
        print(f"\n  files written: {made}")
        check(os.path.getsize(os.path.join(out_dir, 'ad_v.wav')) > 1e5,
              "output WAV written")
        check(os.path.exists(os.path.join(plot_dir, 'v.txt')),
              "text report written")
        if importlib.util.find_spec('matplotlib') is not None:
            check(os.path.exists(os.path.join(plot_dir, 'v.png')),
                  "alignment plot written")
        else:
            print("  matplotlib absent: no .png expected")
    done(t0)


# --- four cards --------------------------------------------------------------

def phase_four_cards(devices):
    t0 = phase("four cards: sharded directory batch against one card")
    from describealign_jax.alignment.api import align_batch_from_pcm
    from describealign_jax.parallel.batch import make_mesh
    check(len(devices) == 4, "four GPUs visible")
    pairs, lens, planted, kinds = batch_pairs()
    mesh = make_mesh(4)
    t = time.time()
    sharded = align_batch_from_pcm(pairs, true_samples=lens, mesh=mesh)
    first = time.time() - t
    peaks = [(d.memory_stats() or {}).get('peak_bytes_in_use', 0)
             for d in devices]
    print(f"  sharded first call (incl. compile) {first:.3f} s; peak bytes "
          f"per device {peaks}")
    check(all(p > 100e6 for p in peaks), "all four cards did work")
    t = time.time()
    sharded = align_batch_from_pcm(pairs, true_samples=lens, mesh=mesh)
    warm = time.time() - t
    t = time.time()
    single = align_batch_from_pcm(pairs, true_samples=lens)
    first1 = time.time() - t
    t = time.time()
    single = align_batch_from_pcm(pairs, true_samples=lens)
    warm1 = time.time() - t
    minutes = sum(a / SR / 60.0 for (_, a) in lens)
    print(f"  warm: four cards {warm:.4f} s ({minutes / warm:.2f} audio-min/s)"
          f", one card {warm1:.4f} s ({minutes / warm1:.2f} audio-min/s; "
          f"first call {first1:.3f} s)")
    check_batch(sharded, planted, kinds)
    for i, (g, w) in enumerate(zip(sharded, single)):
        same = (len(g[0]) == len(w[0])
                and np.allclose(g[0], w[0], atol=1e-6, rtol=0)
                and np.allclose(g[1], w[1], atol=1e-6, rtol=0)
                and abs(g[2] - w[2]) < 1e-9)
        check(same, f"pair {i}: sharded nodes equal the one-card nodes")
    done(t0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--four-cards', action='store_true',
                    help='run only the four-device sharded batch and its '
                         'one-card comparison')
    args = ap.parse_args(argv)
    devices = require_gpu()
    phase_card(devices)
    if args.four_cards:
        phase_four_cards(devices)
    else:
        video, audio, sv, sa = scale_pair()
        from describealign_jax.alignment.api import _bucket_pad
        phase_compile(max(_bucket_pad(sv // FS), _bucket_pad(sa // FS)))
        phase_reference(video, audio, sv, sa, devices[0])
        phase_single(video, audio, sv, sa)
        phase_batch()
        phase_cli()
    print(result_line(devices[0].platform, devices[0].device_kind,
                      len(devices)))


if __name__ == '__main__':
    main()
