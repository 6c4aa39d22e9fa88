"""The F0 error's checks, on the CPU: chip_smoke.py phases 5-5c and the
step tests' ``_check_outputs``; and the checks of phase 6's profile and
phase 11's comparisons.

The F0 error is taken over frames voiced in both the target and the
prediction.  With no such frame it is NaN, and a comparison that scores NaN
against NaN as agreement holds nothing.  Phases 5-5c denormalize V/UV
around 2, so that their small acoustic steps give a number on the CPU, and
``loss_gap`` fails a NaN on one side alone.  ``_check_outputs`` excuses an
f0_rmse gap only together with a vuv_err gap (a V/UV decision flipped).
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from test_torch_step import _check_outputs

import chip_smoke

torch.set_num_threads(1)


@pytest.mark.parametrize("a,b,want", [
    (math.nan, math.nan, 0.0),
    (math.nan, 1.0, math.inf),
    (1.0, math.nan, math.inf),
    (1.5, 1.0, 0.5),
])
def test_loss_gap(a, b, want):
    assert chip_smoke.loss_gap(a, b) == want


@pytest.mark.parametrize("tag", sorted(chip_smoke.SMALL_ACOUSTIC_STEPS))
def test_small_acoustic_step_f0_rmse_is_a_number(tag):
    """Phase 5-5c's step, as the phase runs it on the CPU side (the same
    configuration, batch and statistics), gives a finite f0_rmse and, every
    target and prediction being voiced, vuv_err 0."""
    from gantts_tpu_torch.train.setup import init_models_and_states

    hp = chip_smoke.SMALL_ACOUSTIC_STEPS[tag]()
    hp.discriminator_params.update(dropout=0.0)
    cpu = torch.device("cpu")
    batch, R = chip_smoke.small_step_batch(hp, 64, 4)
    _, _, _, _, gstate, dstate = init_models_and_states(hp, seed=1,
                                                        device=cpu)
    x, y, lengths = (torch.as_tensor(a) for a in batch)
    _, _, out = chip_smoke.make_trainer(hp, cpu).step(
        gstate, dstate, x, y, lengths, torch.as_tensor(R), 1.0)
    assert math.isfinite(float(out["f0_rmse"])) and float(out["f0_rmse"]) > 0
    assert float(out["vuv_err"]) == 0.0


def _outputs(f0, vuv):
    return {"mcd": np.float32(5.0), "f0_rmse": np.float32(f0),
            "vuv_err": np.float32(vuv)}


@pytest.mark.parametrize("f0,vuv,ok", [
    (100.0, 0.1, True),           # equal
    (100.5, 0.1, False),          # an F0 gap with V/UV the same: a fault
    (100.5, 0.1 + 1 / 400, True),  # a V/UV decision flipped
    (100.0, 0.1 + 2 / 400, False),  # more than one frame flipped
])
def test_check_outputs_excuses_f0_only_with_a_vuv_flip(f0, vuv, ok):
    jout = _outputs(100.0, 0.1)
    if ok:
        _check_outputs(jout, _outputs(f0, vuv), 400)
    else:
        with pytest.raises(AssertionError):
            _check_outputs(jout, _outputs(f0, vuv), 400)


def _trace(d, names, files=("trace_epoch2.json",)):
    os.makedirs(d)
    events = [{"name": n, "cat": "kernel"} for n in names] + [
        {"name": "aten::mm", "cat": "cpu_op"}]
    for f in files:
        with open(os.path.join(d, f), "w") as fh:
            json.dump({"traceEvents": events}, fh)
    return d


SRU_K3 = ["void proj_gemm_bf16_kernel<128>(...)", "sru_fwd_scan_kernel",
          "sru_bwd_scan_chunked_kernel", "linear_recurrence_fwd_kernel",
          "linear_recurrence_bwd_kernel"]


@pytest.mark.parametrize("names,files,ok", [
    (SRU_K3, ("trace_epoch2.json",), True),
    (SRU_K3[:2] + SRU_K3[3:], ("trace_epoch2.json",), False),
    (["aten::mm"], ("trace_epoch2.json",), False),
    (SRU_K3, ("trace_epoch3.json",), False),
    (SRU_K3, ("trace_epoch2.json", "trace_epoch3.json"), False)])
def test_check_profile(tmp_path, names, files, ok):
    """Phase 6: one trace, of epoch 2, whose device kernels name the SRU
    and k=3 kernels."""
    prof = _trace(str(tmp_path / "prof"), names, files)
    if ok:
        chip_smoke.check_profile(prof, "card")
    else:
        with pytest.raises(RuntimeError, match="profile"):
            chip_smoke.check_profile(prof, "card")


def _payload(lr=0.01):
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3) / 7
    return {"state_dict": {"w": w.clone()},
            "optimizer": {"state": {0: {"step": torch.tensor(3.0),
                                        "sum": w * w}},
                          "param_groups": [{"lr": lr, "params": [0]}]}}


def test_require_same_states():
    """Phase 11: every tensor's bits, and lr as torch applies it (float32):
    the JAX file's float32 learning rate equals the .pth's 0.01."""
    a = _payload()
    assert chip_smoke.require_same_states("x", a, _payload(
        float(np.float32(0.01)))) == (6, 7)
    b = _payload()
    b["state_dict"]["w"][1, 2] = torch.nextafter(b["state_dict"]["w"][1, 2],
                                                 torch.tensor(2.0))
    c = _payload()
    c["optimizer"]["state"][0]["step"] = torch.tensor(4.0)
    for bad in (b, c, _payload(0.02)):
        with pytest.raises(RuntimeError, match="x"):
            chip_smoke.require_same_states("x", a, bad)


def test_same_tree(tmp_path):
    for d in ("a", "b"):
        os.makedirs(tmp_path / d / "eval")
        (tmp_path / d / "eval" / "u.wav").write_bytes(b"RIFF1")
        (tmp_path / d / "analysis.json").write_text("{}")
    assert chip_smoke.same_tree(str(tmp_path / "a"),
                                str(tmp_path / "b")) == 2
    (tmp_path / "b" / "eval" / "u.wav").write_bytes(b"RIFF2")
    with pytest.raises(RuntimeError, match="u.wav differs"):
        chip_smoke.same_tree(str(tmp_path / "a"), str(tmp_path / "b"))


def test_eval_subset_is_one_eval_and_five_test(tmp_path):
    """Phase 11b's data directory: the 7 shortest utterances (links), the
    stats; the split gives 1 eval and the 5 held out."""
    from gantts_tpu_torch.data import NPYDataSource

    src = tmp_path / "src"
    for d in ("X", "Y"):
        os.makedirs(src / d)
        for i, n in enumerate((50, 9, 30, 8, 7, 60, 6, 5, 40, 4)):
            np.save(src / d / f"u{i}.npy", np.zeros((n, 3), np.float32))
    np.save(src / "data_mean.npy", np.zeros(3))
    dst = chip_smoke.eval_subset(str(src), str(tmp_path / "dst"), ("X", "Y"),
                                 ["data_mean.npy"])
    kept = sorted(os.listdir(os.path.join(dst, "X")))
    assert kept == sorted(os.listdir(os.path.join(dst, "Y"))) == [
        f"u{i}.npy" for i in (1, 2, 3, 4, 6, 7, 9)]
    assert os.path.exists(os.path.join(dst, "data_mean.npy"))
    xdir = os.path.join(dst, "X")
    assert len(NPYDataSource(xdir, train=False).collect_files()) == 1
    assert len(NPYDataSource(xdir, test=True).collect_files()) == 5


@pytest.fixture(scope="module")
def f0_rmse_cause_found(tmp_path_factory):
    """chip_smoke.f0_rmse_cause on a small tts_acoustic corpus (12
    utterances, natural log-F0 about 5, V/UV random) and four full-width
    generators: one as initialised, one whose log-F0 output bias is raised
    by 1e3 normalized units (about 200 in log-F0), one whose V/UV output
    bias is lowered by 1e3 (nothing voiced), and the first again.  On the
    CPU the kernels' plain versions serve, so the guard that refuses them
    is lifted."""
    from contextlib import nullcontext

    from gantts_tpu_torch import hparams
    from gantts_tpu_torch.train.checkpoint import save_checkpoint
    from gantts_tpu_torch.train.setup import init_models_and_states

    tmp = str(tmp_path_factory.mktemp("f0"))
    rs = np.random.RandomState(0)
    for d in ("X_acoustic", "Y_acoustic"):
        os.makedirs(os.path.join(tmp, "feats", d))
    for i in range(12):
        T = rs.randint(60, 100)
        y = rs.randn(T, 187).astype(np.float32)
        y[:, 180:183] = 5 + 0.2 * rs.randn(T, 3)
        y[:, 183] = rs.rand(T) > 0.3
        for d, a in (("X_acoustic", rs.rand(T, 425).astype(np.float32)),
                     ("Y_acoustic", y)):
            np.save(os.path.join(tmp, "feats", d, f"u{i:02d}.npy"), a)
    hp = hparams.tts_acoustic.copy()
    hp.parse(chip_smoke.RESUMES[0][2])
    hp.generator_params.update(in_dim=425, out_dim=187)
    hp.discriminator_params.update(in_dim=483)
    paths = {}
    for label, column, by in (("initialised", 180, 0.0),
                              ("log-F0 raised", 180, 1e3),
                              ("unvoiced", 183, -1e3),
                              ("initialised again", 180, 0.0)):
        g = init_models_and_states(hp, device="cpu")[4]
        with torch.no_grad():
            [b for n, b in g.model.named_parameters()
             if n.endswith("bias")][-1][column] += by
        d = os.path.join(tmp, label)
        os.makedirs(d)
        paths[label] = save_checkpoint(g, 3, d, "Generator")
    guard = chip_smoke.plain_versions_forbidden
    chip_smoke.plain_versions_forbidden = nullcontext
    try:
        return chip_smoke.f0_rmse_cause("card", torch.device("cpu"), tmp,
                                        paths)
    finally:
        chip_smoke.plain_versions_forbidden = guard


@pytest.mark.parametrize("label,blown,empty,f0", [
    ("initialised", False, False, "finite"),
    ("log-F0 raised", True, False, "nan"),
    ("unvoiced", False, True, "nan"),
    ("initialised again", False, False, "finite")])
def test_f0_rmse_cause(f0_rmse_cause_found, label, blown, empty, f0):
    """Phase 11a's reading of a tts f0_rmse that is not finite, in both
    splits: exp of the log-F0 overflows on co-voiced and other frames only
    in the generator whose log-F0 lies near 200 (NaN: inf * 0 on the
    others); batches without a co-voiced frame only in the one that voices
    nothing (NaN)."""
    for split, got in f0_rmse_cause_found[label].items():
        assert (got["over"] > 0) == (got["stray"] > 0) == blown, split
        assert (got["empty"] > 0) == empty, split
        kind = ("nan" if math.isnan(got["f0_rmse"]) else
                "inf" if math.isinf(got["f0_rmse"]) else "finite")
        assert kind == f0, split


@pytest.mark.parametrize("gap,where,worst_above_1,anywhere", [
    (0.0, 0, False, 0.0),      # the same parameters
    (1e-5, 0, True, 1e-5),     # a moved entry whose sign cannot flip
    (0.02, 1, False, 0.02),    # a near-zero gradient's entry: may flip
])
def test_dp_param_gaps(gap, where, worst_above_1, anywhere):
    """Phase 12b's first-step parameter limit: entries whose gradient
    lies well above the gradient limit are held to DP_FIRST_STEP_TOL plus
    Adagrad's slope; those near zero (a sign may flip) are only counted."""
    lr = 0.01
    g = torch.tensor([1.0, 1e-7])
    ref = torch.full((2,), 0.5) - lr * torch.sign(g)
    got = ref.clone()
    got[where] += gap
    worst, any_gap, free = chip_smoke.dp_param_gaps(
        [got], [ref], [g], [g * g], [1.0], lr, ["G.w"])
    assert (worst > 1) == worst_above_1
    assert any_gap == pytest.approx(anywhere, rel=1e-2)  # float32 ulps
    assert free == 1


@pytest.mark.parametrize("scale,ok", [(0.5, True), (2.0, False)])
def test_dp_compare(scale, ok):
    """Phase 12b's gradient limit is DP_GRAD_TOL of the model's largest
    |entry| (G's or D's), not of each tensor's."""
    ref = [torch.tensor([1.0, -0.5]), torch.tensor([1e-4])]
    names = ["G.a", "G.b"]
    grads = [ref[0].clone(), ref[1] + scale * chip_smoke.DP_GRAD_TOL]
    out = {"loss": torch.tensor(1.0)}
    worst_scalar, worst_grad, named = chip_smoke.dp_compare(
        out, grads, out, ref, names)
    assert worst_scalar == 0.0
    assert (worst_grad <= 1) == ok
    assert named[0].startswith("G.b")
