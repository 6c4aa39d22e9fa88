"""The port's host modules of TTS and VC feature work against the JAX
package's, on the same inputs:

  * ``io/hts.py``: parsing and every label method, on state-aligned labels
    (tests/fixtures.py ``make_label_file`` and ``make_tts_corpus``) and on
    phone-aligned ones made from them, and ``set_durations`` -> ``save`` ->
    ``load`` round trips: equal;
  * ``load_question_set`` on the shipped 416-question set and the fixture
    set: equal names and regex patterns, and equal answers on every context;
  * ``io/merlin.py``: phone-level and frame-level ("full") linguistic
    features and duration features: ``array_equal``;
  * the frame helpers of ``preprocessing`` (``interp1d``, ``trim_zeros_frames``,
    ``adjust_frame_length(s)``): equal;
  * ``core/windows.py`` ``mlpg`` with unit and true variances, T in {1, 7,
    300}: within 1e-10 of scale with the C++ engine, bit-equal where both
    packages take scipy;
  * ``postfilters.merlin_post_filter``: within 1e-12;
  * ``preprocessing/alignment.py``: the port's engine's ``dtw_path`` against
    the JAX package's and the NumPy oracle, and ``DTWAligner``: equal paths.
"""

from unittest import mock

import numpy as np
import pytest
from fixtures import make_label_file, make_question_file, make_tts_corpus

from gantts_tpu import postfilters as jax_postfilters
from gantts_tpu import preprocessing as jax_P
from gantts_tpu.core import windows as jax_windows
from gantts_tpu.frontend import native as jax_native
from gantts_tpu.frontend import sptk as jax_sptk
from gantts_tpu.io import hts as jax_hts
from gantts_tpu.io import merlin as jax_merlin
from gantts_tpu.preprocessing import alignment as jax_alignment
from gantts_tpu_torch import hparams, postfilters
from gantts_tpu_torch import preprocessing as P
from gantts_tpu_torch.core import windows
from gantts_tpu_torch.frontend import native
from gantts_tpu_torch.io import hts, merlin
from gantts_tpu_torch.preprocessing import alignment

SHIPPED = hparams.tts_acoustic.question_path
LABEL_ATTRS = ("start_times", "end_times", "contexts", "state_ids",
               "frame_shift")
LABEL_METHODS = ("phone_boundaries", "phone_contexts", "num_frames",
                 "frame_counts", "silence_phone_indices",
                 "silence_frame_indices")


def _phone_aligned(src, dst):
    """A phone-aligned copy of a state-aligned label: one line a phone,
    from its first state's start to its last state's end."""
    labels = jax_hts.load(src)
    with open(dst, "w") as f:
        for s, e in labels.phone_boundaries():
            f.write(f"{labels.start_times[s]} {labels.end_times[e - 1]} "
                    f"{labels.contexts[s]}\n")
    return dst


@pytest.fixture(scope="module")
def labels(tmp_path_factory):
    """name -> (label path, question set path): the fixture label with the
    fixture questions, three corpus labels with the shipped set, and
    phone-aligned copies of both kinds."""
    root = tmp_path_factory.mktemp("labels")
    make_tts_corpus(str(root / "corpus"), num=3)
    out = {"fixture": (make_label_file(str(root / "fixture.lab")),
                       make_question_file(str(root / "questions.hed")))}
    for i in range(3):
        out[f"corpus{i}"] = (str(root / "corpus" / "label_state_align"
                                 / f"utt_{i:04d}.lab"), SHIPPED)
    for name in ("fixture", "corpus0"):
        src, qs = out[name]
        out[name + "_phone"] = (_phone_aligned(src, str(root / f"{name}_ph"
                                                             f".lab")), qs)
    return out


def _same_labels(a, b):
    for attr in LABEL_ATTRS:
        assert getattr(a, attr) == getattr(b, attr), attr
    assert len(a) == len(b)
    assert a.is_state_alignment == b.is_state_alignment
    assert a.num_states == b.num_states
    for m in LABEL_METHODS:
        ra, rb = getattr(a, m)(), getattr(b, m)()
        if isinstance(rb, np.ndarray):
            assert ra.dtype == rb.dtype, m
            np.testing.assert_array_equal(ra, rb, err_msg=m)
        else:
            assert ra == rb, m


@pytest.mark.parametrize("name", ["fixture", "corpus0", "fixture_phone",
                                  "corpus0_phone"])
def test_hts_labels_match_jax(labels, name, tmp_path):
    path, _ = labels[name]
    got, ref = hts.load(path), jax_hts.load(path)
    _same_labels(got, ref)
    assert got.is_state_alignment == (not name.endswith("_phone"))
    assert got.silence_frame_indices().size > 0
    # a custom silence pattern reaches the same phones in both
    for m in ("silence_phone_indices", "silence_frame_indices"):
        np.testing.assert_array_equal(getattr(got, m)(r"\-(hh|sil)\+"),
                                      getattr(ref, m)(r"\-(hh|sil)\+"))

    # set_durations -> save -> load: the same file and the same labels
    dur = np.random.RandomState(len(got)).randint(1, 7, size=(len(got), 1))
    got.set_durations(dur.astype(np.float64))
    ref.set_durations(dur.astype(np.float64))
    got.save(tmp_path / "port.lab")
    ref.save(tmp_path / "jax.lab")
    assert (tmp_path / "port.lab").read_text() == \
        (tmp_path / "jax.lab").read_text()
    back, back_ref = hts.load(tmp_path / "port.lab"), jax_hts.load(
        tmp_path / "jax.lab")
    _same_labels(back, back_ref)
    assert back.num_frames() == int(dur.sum())
    with pytest.raises(ValueError):
        got.set_durations(np.ones(len(got) + 1))


def test_hts_line_forms_match_jax():
    """Lines without times, blank lines, and a malformed line."""
    lines = ["x^a-b+c=d", "", "  y^b-c+d=e[3]  "]
    _same_labels(hts.HTSLabelFile.from_lines(lines),
                 jax_hts.HTSLabelFile.from_lines(lines))
    for mod in (hts, jax_hts):
        with pytest.raises(ValueError, match="Malformed"):
            mod.HTSLabelFile.from_lines(["0 50000"])


def _contexts(labels):
    return sorted({c for path, _ in labels.values()
                   for c in jax_hts.load(path).contexts})


@pytest.mark.parametrize("which", ["shipped", "fixture"])
def test_question_sets_match_jax(labels, which):
    qs = SHIPPED if which == "shipped" else labels["fixture"][1]
    got, ref = hts.load_question_set(qs), jax_hts.load_question_set(qs)
    for g, r in zip(got, ref):
        assert list(g) == list(r)
        for i in r:
            assert g[i][0] == r[i][0]
            if isinstance(r[i][1], list):
                assert [p.pattern for p in g[i][1]] == \
                    [p.pattern for p in r[i][1]]
            else:
                assert g[i][1].pattern == r[i][1].pattern
    if which == "shipped":
        assert len(got[0]) + len(got[1]) == 416
    for i, ctx in enumerate(_contexts(labels)):
        np.testing.assert_array_equal(
            merlin._answer_questions(ctx, *got),
            jax_merlin._answer_questions(ctx, *ref), err_msg=ctx)
    for pattern in ("*-sil+*", "a?c*", "x^*", "*/B:1-*", "+x"):
        assert hts._wildcard_to_regex(pattern) == \
            jax_hts._wildcard_to_regex(pattern)


@pytest.mark.parametrize("name", ["fixture", "corpus0", "corpus1",
                                  "corpus2", "fixture_phone"])
def test_linguistic_and_duration_features_match_jax(labels, name):
    path, qs = labels[name]
    got_l, ref_l = hts.load(path), jax_hts.load(path)
    got_q, ref_q = hts.load_question_set(qs), jax_hts.load_question_set(qs)
    modes = [dict(add_frame_features=False, subphone_features=None),
             dict(add_frame_features=True, subphone_features="full"),
             dict(add_frame_features=True, subphone_features=None)]
    for kw in modes:
        got = merlin.linguistic_features(got_l, *got_q, **kw)
        ref = jax_merlin.linguistic_features(ref_l, *ref_q, **kw)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    if qs == SHIPPED:
        assert got.shape[1] == 416 and ref.std(axis=0).max() > 0
    got, ref = merlin.duration_features(got_l), jax_merlin.duration_features(
        ref_l)
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == ref_l.num_frames()
    for mod in (merlin, jax_merlin):
        with pytest.raises(ValueError, match="subphone"):
            mod.linguistic_features(ref_l, *ref_q, add_frame_features=True,
                                    subphone_features="coarse_coding")


def _f0(T, voiced, rs):
    f0 = np.zeros((T, 1))
    idx = rs.choice(T, size=voiced, replace=False)
    f0[idx, 0] = np.log(rs.uniform(80, 300, size=voiced))
    return f0


@pytest.mark.parametrize("voiced", [0, 1, 3, 40])
@pytest.mark.parametrize("kind", ["slinear", "quadratic"])
def test_interp1d_matches_jax(kind, voiced):
    rs = np.random.RandomState(voiced)
    f0 = _f0(100, voiced, rs)
    for x in (f0, f0[:, 0], f0.astype(np.float32)):
        got, ref = P.interp1d(x, kind=kind), jax_P.interp1d(x, kind=kind)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    if voiced:
        assert (P.interp1d(f0, kind=kind) != 0).all()


def test_frame_helpers_match_jax():
    rs = np.random.RandomState(0)
    x = np.vstack([rs.randn(37, 5), np.zeros((6, 5)), 1e-9 * np.ones((2, 5))])
    y = rs.randn(50, 5)
    for eps in (1e-7, 1e-10):
        np.testing.assert_array_equal(P.trim_zeros_frames(x, eps),
                                      jax_P.trim_zeros_frames(x, eps))
    assert len(P.trim_zeros_frames(x)) == 37
    assert len(P.trim_zeros_frames(np.zeros((4, 3)))) == 0
    for pad in (True, False):
        for div in (1, 2, 3, 8):
            np.testing.assert_array_equal(
                P.adjust_frame_length(x, pad=pad, divisible_by=div),
                jax_P.adjust_frame_length(x, pad=pad, divisible_by=div))
            for got, ref in zip(
                    P.adjust_frame_lengths(x, y, pad=pad, divisible_by=div),
                    jax_P.adjust_frame_lengths(x, y, pad=pad,
                                               divisible_by=div)):
                np.testing.assert_array_equal(got, ref)
        for got, ref in zip(
                P.adjust_frame_lengths(y[:33], x, pad=pad, ensure_even=True),
                jax_P.adjust_frame_lengths(y[:33], x, pad=pad,
                                           ensure_even=True)):
            np.testing.assert_array_equal(got, ref)
            assert len(got) % 2 == 0
    np.testing.assert_array_equal(P._fix_length(y[:, 0], 60),
                                  jax_P._fix_length(y[:, 0], 60))


def _no_engines():
    return (mock.patch.object(jax_native, "_load", lambda: None),
            mock.patch.object(native, "_load", lambda: None))


@pytest.mark.parametrize("T", [1, 7, 300])
@pytest.mark.parametrize("variance", ["unit", "true"])
def test_mlpg_matches_jax(T, variance):
    W = hparams.tts_acoustic.windows
    D = 4
    rs = np.random.RandomState(T)
    static = np.cumsum(rs.randn(T, D), axis=0)
    means = windows.delta_features(static, W) + 0.1 * rs.randn(T, 3 * D)
    var = (np.ones(3 * D) if variance == "unit"
           else rs.uniform(0.2, 3.0, size=3 * D))
    assert native.available(), native.engine()
    got = windows.mlpg(means, var, W)
    ref = jax_windows.mlpg(means, var, W)
    scale = np.abs(ref).max()
    assert got.shape == (T, D)
    assert np.abs(got - ref).max() <= 1e-10 * scale
    # a frame-variant array takes its first row, in both
    tiled = np.tile(var, (T, 1))
    assert np.abs(windows.mlpg(means, tiled, W) - ref).max() <= 1e-10 * scale
    a, b = _no_engines()
    with a, b:
        np.testing.assert_array_equal(windows.mlpg(means, var, W),
                                      jax_windows.mlpg(means, var, W))
    if variance == "unit":  # exact deltas give back the statics
        exact = windows.mlpg(windows.delta_features(static, W), var, W)
        assert np.abs(exact - static).max() <= 1e-9 * np.abs(static).max()
    for mod in (windows, jax_windows):
        with pytest.raises(ValueError):
            mod.mlpg(means[:, :-1], var, W)


def test_banded_solve_engine_matches_scipy():
    """The port's engine's banded Cholesky against scipy; shapes the
    engine's entry points do not take, and a matrix that is not positive
    definite, refused."""
    import scipy.linalg

    rs = np.random.RandomState(0)
    T, b = 50, 2
    ab = np.zeros((b + 1, T))
    ab[-1] = 4.0 + rs.rand(T)
    ab[:-1] = rs.uniform(-0.5, 0.5, size=(b, T))
    rhs = rs.randn(T, 3)
    got = native.banded_cholesky_solve(ab, rhs, bandwidth=b)
    ref = scipy.linalg.solveh_banded(ab, rhs, lower=False)
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    with pytest.raises(ValueError, match="expected"):
        native.banded_cholesky_solve(ab, rhs[:-1], bandwidth=b)
    with pytest.raises(ValueError, match="expected"):
        native.dtw_path(rhs, rhs[:, :2])
    ab[-1, 7] = -1.0
    with pytest.raises(np.linalg.LinAlgError):
        native.banded_cholesky_solve(ab, rhs, bandwidth=b)


@pytest.mark.parametrize("coef", [1.4, 1.0])
def test_merlin_post_filter_matches_jax(coef):
    rs = np.random.RandomState(0)
    fs, fftlen = 16000, 1024
    f = np.linspace(0, fs / 2, fftlen // 2 + 1)
    logsp = (-3.0 + 1.2 * np.exp(-((f - 1000) / 200) ** 2)
             + 0.1 * rs.randn(6, 1))
    alpha = jax_sptk.mcepalpha(fs)
    mgc = jax_sptk.sp2mc(np.exp(2 * logsp), order=59, alpha=alpha)
    got = postfilters.merlin_post_filter(mgc, alpha, coef=coef)
    ref = jax_postfilters.merlin_post_filter(mgc, alpha, coef=coef)
    assert got.shape == mgc.shape
    assert np.abs(got - ref).max() <= 1e-12
    if coef == 1.0:  # no lifter: the power match leaves the track as it was
        assert np.abs(got - mgc).max() < 1e-6


def _trajectories(rs, T, D=6):
    return np.cumsum(rs.randn(T, D), axis=0)


@pytest.mark.parametrize("Tx,Ty", [(1, 1), (1, 9), (40, 23), (120, 150)])
def test_dtw_path_matches_jax(Tx, Ty):
    rs = np.random.RandomState(Tx + Ty)
    x, y = _trajectories(rs, Tx), _trajectories(rs, Ty)
    assert native.available(), native.engine()
    got = alignment.dtw_path(x, y)
    oracle = alignment._dtw_path_numpy(x, y)
    ref = jax_alignment.dtw_path(x, y)
    for g, o, r in zip(got, oracle, ref):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, o)
        np.testing.assert_array_equal(g, r)
    np.testing.assert_array_equal(oracle[0],
                                  jax_alignment._dtw_path_numpy(x, y)[0])
    px, py = got
    assert (px[0], py[0], px[-1], py[-1]) == (0, 0, Tx - 1, Ty - 1)
    assert set(np.diff(px)) <= {0, 1} and set(np.diff(py)) <= {0, 1}


def test_dtw_aligner_matches_jax():
    rs = np.random.RandomState(0)
    N, Tmax, D = 3, 90, 5
    X = np.zeros((N, Tmax, D), np.float32)
    Y = np.zeros((N, Tmax, D), np.float32)
    for i, (tx, ty) in enumerate([(90, 70), (50, 61), (33, 33)]):
        X[i, :tx] = _trajectories(rs, tx, D)
        Y[i, :ty] = _trajectories(rs, ty, D)
    got = P.DTWAligner().transform((X, Y))
    ref = jax_P.DTWAligner().transform((X, Y))
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    a, b = _no_engines()
    with a, b:
        for g, r in zip(P.DTWAligner().transform((X, Y)), ref):
            np.testing.assert_array_equal(g, r)
