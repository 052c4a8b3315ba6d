"""PyTorch port: ingest from raw ``.mat`` files against the JAX package's
(``contrastiveprosthetics_torch.data.ingest``, ``ops.stats``, ``ops.signal``
and ``cli.load``), on the CPU.

The ``.mat`` writers, the Welford statistics, the scipy-backend ingest and
the glove ingest are numpy in both packages and must be equal bit for bit.
The device backend differs by design: the JAX package runs its IIR as an
XLA scan and its RMS as a cumulative-sum difference, the port the
``iir_rms_frames`` plain version (on the card its kernel, bit for bit):
the IIR in sections with the same operation order, each window's squares
summed oldest first. Both are f32: against float64 scipy the port's frames
lie within 2e-5 relative and the JAX package's within 1e-4 (the
cumulative sum cancels digits), so frames are held at rtol 1e-3 (as
``test_signal.py`` holds two JAX lowerings of the same pipeline) and the
normalized artifacts at rtol 1e-3, atol 1e-4 (values of order 1-10, one
f32 pipeline against another).
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io as sio
import torch

from contrastiveprosthetics_torch.cli import load as port_cli
from contrastiveprosthetics_torch.config import DEFAULT_CONFIG as CFG
from contrastiveprosthetics_torch.config import compat_config
from contrastiveprosthetics_torch.data import ingest as port_ingest
from contrastiveprosthetics_torch.data import synthetic as port_synth
from contrastiveprosthetics_torch.data.store import DeviceStore
from contrastiveprosthetics_torch.ops import signal as port_signal
from contrastiveprosthetics_torch.ops import stats as port_stats
from contrastiveprosthetics_tpu.config import DEFAULT_CONFIG as JAX_CFG
from contrastiveprosthetics_tpu.config import compat_config as jax_compat
from contrastiveprosthetics_tpu.data import ingest as jax_ingest
from contrastiveprosthetics_tpu.data import synthetic as jax_synth
from contrastiveprosthetics_tpu.data.store import DeviceStore as JaxStore
from contrastiveprosthetics_tpu.ops import signal as jax_signal
from contrastiveprosthetics_tpu.ops import stats as jax_stats

torch.set_num_threads(1)

POSITIONS = [0, 40]  # one DB2 and one DB3 subject
GLOVE_PEOPLE = [28, 29]
FRAME_TOL = dict(rtol=1e-3, atol=1e-6)
ARTIFACT_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def mat_root(tmp_path_factory):
    """A ``.mat`` tree written by the port's writers."""
    root = str(tmp_path_factory.mktemp("ninapro_port"))
    port_synth.write_emg_mat_files(root, CFG, POSITIONS)
    port_synth.write_glove_mat_files(root, CFG, people=GLOVE_PEOPLE)
    return root


def _mats(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            m = sio.loadmat(path)
            out[os.path.relpath(path, root)] = {
                k: v for k, v in m.items() if not k.startswith("__")}
    return out


def test_mat_writers_match_jax(mat_root, tmp_path):
    """Same files, keys, arrays and dtypes as the JAX writers (the files'
    headers carry a timestamp, so arrays are compared, not bytes)."""
    jax_synth.write_emg_mat_files(str(tmp_path), JAX_CFG, POSITIONS)
    jax_synth.write_glove_mat_files(str(tmp_path), JAX_CFG,
                                    people=GLOVE_PEOPLE)
    ours, theirs = _mats(mat_root), _mats(str(tmp_path))
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == 2 * (len(POSITIONS) + len(GLOVE_PEOPLE))
    for name, arrays in theirs.items():
        assert sorted(ours[name]) == sorted(arrays), name
        for key, want in arrays.items():
            got = ours[name][key]
            assert got.dtype == want.dtype, (name, key)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {key}")
    emg = ours["db2/s23/S23_E1_A1.mat"]["emg"]  # position 0 is subject 22
    assert emg.shape == (18 * 6 * (CFG.ingest_segment_len + 10), 12)


@pytest.mark.parametrize("complete", [False, True])
def test_running_stats_and_welford_bit_equal(complete):
    rng = np.random.default_rng(3)
    windows = rng.standard_normal((30, 100, 12)) * rng.uniform(0.1, 3, 12)
    ours = port_stats.RunningStats(complete=complete)
    theirs = jax_stats.RunningStats(complete=complete)
    for w in windows:
        ours.push(w)
        theirs.push(w)
    for a, b in ((ours.mean(), theirs.mean()), (ours.std(), theirs.std()),
                 (ours.variance(), theirs.variance()),
                 (ours.normalize(windows), theirs.normalize(windows))):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the quirk: a scalar mean with a per-channel std
    assert ours.mean().shape == (() if complete else (12,))
    assert ours.std().shape == (12,)
    for a, b in zip(port_stats.welford_over_means(windows, complete),
                    jax_stats.welford_over_means(windows, complete)):
        assert np.shape(a) == np.shape(b)
        np.testing.assert_array_equal(a, b)


def test_running_stats_save(tmp_path):
    stats = port_stats.RunningStats(save_prefix=str(tmp_path / "s" / "emg_"))
    for w in np.random.default_rng(4).standard_normal((5, 10, 3)):
        stats.push(w)
    stats.save()
    np.testing.assert_array_equal(np.load(tmp_path / "s" / "emg_mean.npy"),
                                  stats.mean())
    with pytest.raises(ValueError, match="save_prefix"):
        port_stats.RunningStats().save()


def _artifacts(out):
    with np.load(os.path.join(out, "emg.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    for name in ("emg_mean", "emg_std"):
        arrays[name] = np.load(os.path.join(out, name + ".npy"))
    return arrays


@pytest.mark.parametrize("complete", [False, True])
def test_scipy_backend_ingest_bit_equal_to_jax(mat_root, tmp_path, complete):
    """The float64 oracle backend: the same ``emg``, ``mean`` and ``std``,
    and the same files, key for key, with ``complete``'s quirk."""
    ours = port_ingest.ingest_emg(CFG, mat_root, str(tmp_path / "p"),
                                  POSITIONS, complete=complete,
                                  backend="scipy", verbose=False)
    theirs = jax_ingest.ingest_emg(JAX_CFG, mat_root, str(tmp_path / "j"),
                                   POSITIONS, complete=complete,
                                   backend="scipy", verbose=False)
    for key in ("emg", "mean", "std"):
        assert np.shape(ours[key]) == np.shape(theirs[key])
        np.testing.assert_array_equal(ours[key], theirs[key])
    a, b = _artifacts(str(tmp_path / "p")), _artifacts(str(tmp_path / "j"))
    assert sorted(a) == sorted(b)
    for key in b:
        assert a[key].dtype == b[key].dtype, key
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert a["emg"].shape == (2, 41, 6, 100, 12)
    assert a["emg_mean"].shape == (() if complete else (12,))
    assert [t["person"] for t in ours["timings"]] == [
        int(CFG.people()[p]) for p in POSITIONS]


def test_torch_backend_ingest_matches_jax_device_backend(mat_root, tmp_path):
    """The torch backend on the CPU against the JAX backend: one subject,
    artifacts within ARTIFACT_TOL; ``jax`` is another name for the port's
    device backend and gives the same bits."""
    pos = [40]
    ours = port_ingest.ingest_emg(CFG, mat_root, str(tmp_path / "p"), pos,
                                  backend="torch", verbose=False,
                                  device="cpu")
    alias = port_ingest.ingest_emg(CFG, mat_root, str(tmp_path / "a"), pos,
                                   backend="jax", verbose=False,
                                   device="cpu")
    theirs = jax_ingest.ingest_emg(JAX_CFG, mat_root, str(tmp_path / "j"),
                                   pos, backend="jax", verbose=False)
    np.testing.assert_array_equal(alias["emg"], ours["emg"])
    a, b = _artifacts(str(tmp_path / "p")), _artifacts(str(tmp_path / "j"))
    for key in b:
        assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype
    np.testing.assert_array_equal(a["people_positions"], b["people_positions"])
    np.testing.assert_allclose(a["emg"], b["emg"], **ARTIFACT_TOL)
    np.testing.assert_allclose(a["emg_mean"], b["emg_mean"], rtol=1e-4)
    np.testing.assert_allclose(a["emg_std"], b["emg_std"], rtol=1e-3)
    with pytest.raises(ValueError, match="backend must be one of"):
        port_ingest.ingest_emg(CFG, mat_root, str(tmp_path / "x"), pos,
                               backend="numpy", verbose=False)


def test_glove_ingest_bit_equal_to_jax(mat_root, tmp_path):
    ours = port_ingest.ingest_glove(CFG, mat_root, str(tmp_path / "p"),
                                    people=GLOVE_PEOPLE, verbose=False)
    theirs = jax_ingest.ingest_glove(JAX_CFG, mat_root, str(tmp_path / "j"),
                                     people=GLOVE_PEOPLE, verbose=False)
    for key in ("glove", "mean", "std"):
        np.testing.assert_array_equal(ours[key], theirs[key])
    for name in ("glove_mean.npy", "glove_std.npy"):
        a, b = (np.load(str(tmp_path / d / name)) for d in ("p", "j"))
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    with np.load(str(tmp_path / "p" / "glove.npz")) as z:
        assert z["glove"].shape == (41, 300, 20)
        assert z["glove"].dtype == np.float32


def _labelled_files(seed, missing=None):
    """Two exercise files in the reference's layout, harder than the
    writer's: rest (stim 0, rep 0) between runs, some (stim, rep)s split
    into two runs apart, some shorter than ``ingest_segment_len``, runs in
    no (stim, rep) order, int32 labels of shape (T, 1). Channel 0 of
    ``emg`` is the sample's row in the two files laid end to end, so a
    segment's values name its rows. ``missing``: a (stim, rep) relabelled
    as rest."""
    rng = np.random.default_rng(seed)
    L = CFG.ingest_segment_len
    Es, offset = [], 0
    for stims in (range(0, 18), range(18, 41)):
        runs = []
        for stim in stims:
            for rep in range(1, CFG.max_reps + 1):
                n = int(rng.choice([L + 10, L - 700, L + 300, 40]))
                cut = int(rng.integers(1, n)) if rng.random() < 0.3 else n
                runs += [(stim, rep, cut), (stim, rep, n - cut)]
        rng.shuffle(runs)
        stim_col, rep_col = [], []
        for stim, rep, n in runs:
            if (stim, rep) == missing:
                stim, rep = 0, 0
            gap = int(rng.integers(0, 30))
            stim_col += [np.zeros(gap, np.int32), np.full(n, stim, np.int32)]
            rep_col += [np.zeros(gap, np.int32), np.full(n, rep, np.int32)]
        stim_arr = np.concatenate(stim_col)[:, None]
        rep_arr = np.concatenate(rep_col)[:, None]
        T = stim_arr.shape[0]
        emg = rng.standard_normal((T, 12))
        emg[:, 0] = offset + np.arange(T)
        Es.append((np.asfortranarray(emg), stim_arr, rep_arr))
        offset += T
    return tuple(Es)


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_rows_are_jax_extract_segment(seed):
    """``_segment_rows``' one label pass per file gives, for every (stim,
    rep) the ingest visits, exactly the rows of the JAX package's boolean
    mask and its edge padding (``_extract_segment``), as a table into the
    two files laid end to end."""
    Es = _labelled_files(seed)
    rows = port_ingest._segment_rows(CFG, Es)
    assert rows.dtype == np.int32
    assert rows.shape == (CFG.max_tasks * CFG.max_reps, CFG.ingest_segment_len)
    emg = np.concatenate([E[0] for E in Es])
    k = 0
    for stim in range(CFG.max_tasks):
        for rep in range(1, CFG.max_reps + 1):
            want = jax_ingest._extract_segment(JAX_CFG, Es, stim, rep)
            np.testing.assert_array_equal(rows[k], want[:, 0])
            np.testing.assert_array_equal(emg[rows[k]], want)
            k += 1


def test_segment_rows_raise_as_jax_for_a_missing_segment():
    Es = _labelled_files(2, missing=(23, 4))
    for fn, cfg in ((port_ingest._segment_rows, CFG),
                    (lambda c, E: [jax_ingest._extract_segment(c, E, s, r)
                                   for s in range(41) for r in range(1, 7)],
                     JAX_CFG)):
        with pytest.raises(ValueError, match="no samples for stim=23 rep=4"):
            fn(cfg, Es)


def test_device_backend_builds_no_segment_masks(mat_root, tmp_path,
                                                monkeypatch):
    """The torch backend reads the recordings through the row table: it
    never extracts a segment on the host, and its artifacts equal those of
    a run on the host's extracted segments, bit for bit."""
    def no_masks(*args, **kwargs):
        raise AssertionError("a segment extracted on the host")

    want = port_ingest.ingest_emg(CFG, mat_root, str(tmp_path / "a"), [0],
                                  verbose=False, device="cpu")
    monkeypatch.setattr(port_ingest, "_extract_segment", no_masks)
    got = port_ingest.ingest_emg(CFG, mat_root, str(tmp_path / "b"), [0],
                                 verbose=False, device="cpu")
    np.testing.assert_array_equal(got["emg"], want["emg"])
    with pytest.raises(AssertionError, match="extracted on the host"):
        port_ingest.ingest_emg(CFG, mat_root, str(tmp_path / "c"), [0],
                               backend="scipy", verbose=False)


def test_glove_ingest_with_split_runs_bit_equal_to_jax(tmp_path):
    """Glove files whose (stim, rep) runs are split, out of order, between
    rest, some reps missing (ragged tasks, cut to the shortest): both
    packages give the same corpus and statistics, bit for bit."""
    rng = np.random.default_rng(5)
    for person in (28, 29):
        d = tmp_path / f"s_{person + 1}_angles"
        d.mkdir()
        for ex, stims in (("1", range(0, 18)), ("2", range(18, 41))):
            runs = [(stim, rep, n) for stim in stims
                    for rep in range(1, CFG.max_reps + 1)
                    if (stim * 7 + rep + person) % 23
                    for n in (int(rng.integers(3, 20)),
                              int(rng.integers(0, 25)))]
            rng.shuffle(runs)
            cols = [(np.full(n, s), np.full(n, r), rng.normal(s, 1, (n, 22)))
                    for s, r, n in runs]
            sio.savemat(str(d / f"S{person + 1}_E{ex}_A1.mat"), {
                "angles": np.concatenate([c[2] for c in cols]),
                "restimulus": np.concatenate([c[0] for c in cols])[:, None],
                "rerepetition": np.concatenate([c[1] for c in cols])[:, None]})
    ours = port_ingest.ingest_glove(CFG, str(tmp_path), str(tmp_path / "p"),
                                    people=[28, 29], verbose=False)
    theirs = jax_ingest.ingest_glove(JAX_CFG, str(tmp_path),
                                     str(tmp_path / "j"), people=[28, 29],
                                     verbose=False)
    for key in ("glove", "mean", "std"):
        assert np.shape(ours[key]) == np.shape(theirs[key])
        np.testing.assert_array_equal(ours[key], theirs[key])


def _segments(B, seed):
    rng = np.random.default_rng(seed)
    gain = rng.uniform(0.3, 2.0, (B, 1, 12))
    return (rng.standard_normal((B, CFG.ingest_segment_len, 12)) * gain
            * 1e-4).astype(np.float32)


@pytest.mark.parametrize("compat", [False, True])
def test_preprocess_segments_matches_jax_preprocess_segment(compat):
    """Seeded EMG-scale segments at the default time mask (stride 20, one
    ``iir_rms_frames`` call) and the compat uint8 one (stride 1 to its
    largest index, then a gather)."""
    cfg, jcfg = ((compat_config(CFG), jax_compat(JAX_CFG)) if compat
                 else (CFG, JAX_CFG))
    tm = cfg.time_mask()
    np.testing.assert_array_equal(tm, jcfg.time_mask())
    assert (port_signal.time_mask_stride(tm) is None) == compat
    segs = _segments(6, seed=21 + compat)
    sos = port_signal.butter_bandpass_sos(20, 450, cfg.hz)
    fn = jax.jit(jax.vmap(lambda s: jax_signal.preprocess_segment(
        s, jnp.asarray(sos), jnp.asarray(tm))))
    want = np.asarray(fn(jnp.asarray(segs)))
    got = port_signal.preprocess_segments(
        torch.from_numpy(segs), torch.tensor(sos, dtype=torch.float32), tm)
    assert got.shape == want.shape == (6, 100, 12)
    np.testing.assert_allclose(got.numpy(), want, **FRAME_TOL)


def test_preprocess_segments_against_float64_scipy():
    """The port's frames against float64 scipy (``sosfilt`` and the
    reference's trimmed ``uniform_filter1d`` RMS): within 1e-4 relative."""
    from scipy import signal as ssig
    from scipy.ndimage import uniform_filter1d

    segs = _segments(4, seed=8)
    sos = port_signal.butter_bandpass_sos(20, 450, CFG.hz)
    tm = CFG.time_mask()
    got = port_signal.preprocess_segments(
        torch.from_numpy(segs), torch.tensor(sos, dtype=torch.float32), tm)
    y = ssig.sosfilt(sos, segs.astype(np.float64) * 2.0**10, axis=1)
    rms = np.sqrt(uniform_filter1d(y * y, size=11, axis=1, mode="nearest"))
    want = rms[:, 5:-5][:, tm]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-8)


def test_time_mask_stride():
    assert port_signal.time_mask_stride(np.arange(0, 2000, 20)) == 20
    assert port_signal.time_mask_stride(np.arange(0, 50)) == 1
    assert port_signal.time_mask_stride([0]) == 1
    assert port_signal.time_mask_stride([0, 20, 41]) is None
    assert port_signal.time_mask_stride([5, 25]) is None
    assert port_signal.time_mask_stride([]) is None


@pytest.mark.parametrize("order,band,btype", [
    (2, 0.2, "lowpass"), (2, (0.1, 0.4), "bandpass")])
def test_lfilter_and_butter_bandpass_match_jax(order, band, btype):
    """The (b, a) design equals the JAX one; the f32 polynomial IIR matches
    JAX's scan and float64 scipy on low-order filters (the order-8
    band-pass in polynomial form loses digits in f32 in both packages,
    which is why the ingest filters in sections)."""
    from scipy import signal as ssig

    for ours, theirs in zip(port_signal.butter_bandpass(20, 450, 2000),
                            jax_signal.butter_bandpass(20, 450, 2000)):
        assert ours.dtype == theirs.dtype == np.float64
        np.testing.assert_array_equal(ours, theirs)
    b, a = ssig.butter(order, band, btype=btype)
    x = np.random.default_rng(1).standard_normal((200, 4))
    x32 = x.astype(np.float32)
    got = port_signal.lfilter(b, a, torch.from_numpy(x32)).numpy()
    want = np.asarray(jax_signal.lfilter(jnp.asarray(b), jnp.asarray(a),
                                         jnp.asarray(x32)))
    assert got.dtype == np.float32 and got.shape == x.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, ssig.lfilter(b, a, x, axis=0),
                               rtol=1e-3, atol=1e-4)


def test_port_artifacts_load_in_both_stores(mat_root, tmp_path):
    """The torch-backend artifacts (and the glove corpus) through the
    port's ``DeviceStore.load`` and the JAX one: the same tensors and the
    same split views."""
    out = str(tmp_path)
    port_ingest.ingest_emg(CFG, mat_root, out, POSITIONS, verbose=False,
                           device="cpu")
    port_ingest.ingest_glove(CFG, mat_root, out, people=GLOVE_PEOPLE,
                             verbose=False)
    ours = DeviceStore.load(CFG, out, device="cpu")
    theirs = JaxStore.load(JAX_CFG, out)
    np.testing.assert_array_equal(ours.emg.numpy(), np.asarray(theirs.emg))
    np.testing.assert_array_equal(ours.glove.numpy(),
                                  np.asarray(theirs.glove))
    assert ours.emg.shape == (41, 2, 6, 100, 12)
    for split in ("train", "val", "test"):
        a, b = ours.view(split), theirs.view(split)
        assert (a.n_people, a.n_reps, a.D) == (b.n_people, b.n_reps, b.D)
        np.testing.assert_array_equal(a.emg_flat.numpy(),
                                      np.asarray(b.emg_flat))
        a.check_indexing()


def test_cli_load_on_cpu(tmp_path, capsys):
    """``cptorch-load --platform cpu --synthetic_fixture --load --info``:
    the fixture, both artifacts and the split geometry; then ``--viz`` of
    one (person, task, rep) from the same store."""
    root, data = tmp_path / "mats", tmp_path / "data"
    rc = port_cli.main(["--platform", "cpu", "--synthetic_fixture",
                        "--root", str(root), "--people", "40", "--load",
                        "--data_dir", str(data), "--info", "--check_glove"])
    assert rc == 0
    out = capsys.readouterr().out
    # position 40 is person 44, DB3 subject 5 (reference load.py:124-128)
    assert "ingested person 44 (db3/s5) [1/1]: read" in out
    assert "ingested glove person 29" in out
    assert "glove corpus check: 0 issue(s)" in out
    assert "TRAIN: tasks=41 people=1 reps=3 D=300 total=12300" in out
    assert "TEST: tasks=41 people=1 reps=2 D=8" in out
    with np.load(data / "emg.npz") as z:
        assert z["emg"].shape == (1, 41, 6, 100, 12)
    with np.load(data / "glove.npz") as z:
        assert z["glove"].shape == (41, 300, 20)
    store = DeviceStore.load(CFG, str(data), device="cpu")
    flat = store.view("train").emg_flat
    assert f"range [{float(flat.min()):.6g}, {float(flat.max()):.6g}]" in out

    pytest.importorskip("matplotlib")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert port_cli.main(["--platform", "cpu", "--data_dir", str(data),
                              "--viz", "--task", "3", "--rep", "2"]) == 0
    finally:
        os.chdir(cwd)
    assert (tmp_path / "viz_person0_task3_rep2.png").stat().st_size > 0


def test_cli_load_default_platform_needs_a_gpu(tmp_path, monkeypatch):
    """Without ``--platform cpu`` the CLI asks for cuda and, with no GPU,
    raises before it ingests anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("CPTORCH_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(["--synthetic_fixture", "--root", str(tmp_path),
                       "--people", "40", "--load", "--data_dir",
                       str(tmp_path / "d")])
    assert not (tmp_path / "d").exists() and not (tmp_path / "db3").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_ingest.ingest_emg(CFG, str(tmp_path), str(tmp_path / "d"), [40],
                               verbose=False)


def test_cli_load_takes_the_jax_cli_flags():
    """Every flag of the JAX ``cptpu-load`` parses with its default, and
    ``--backend`` takes the JAX names."""
    from contrastiveprosthetics_tpu.cli import load as jax_cli

    ours = vars(port_cli.build_parser().parse_args([]))
    theirs = vars(jax_cli.build_parser().parse_args([]))
    assert set(theirs) <= set(ours)
    for key, value in theirs.items():
        if key != "backend":
            assert ours[key] == value, key
    assert ours["backend"] == "torch"
    for name in ("jax", "scipy", "torch"):
        assert port_cli.build_parser().parse_args(
            ["--backend", name]).backend == name
