"""The port's profiling tools on the CPU: tools/torch_trace_report.py on
hand-written Chrome traces and on a trace of the port's command line,
tools/torch_profile_step.py's components against the JAX package's
computation of each (the expressions of tools/profile_step.py), and both
tools/torch_profile_step.py and tools/torch_host_pipeline_bench.py end to
end at a tiny size.

The components run at a 2x16 bidirectional relu SRU generator, a 2x8 MLP
discriminator, the 3-layer bidirectional 16-wide LSTM trunk, B=2, T=32,
float32, dropout off, with weights made by the JAX package's ``init`` and
carried over by ``convert.flax_to_torch``.  Tolerances, those of the
existing parity tests:

  * forward outputs at atol 1e-5 (tests/test_torch_models.py: other
    summation orders over <= 425 inputs and 32 scan steps), the matmul
    bound's sum of 12 x 64 x 64 entries at 1e-5 relative;
  * gradients at 1e-4 of each tensor's largest entry
    (tests/test_torch_step.py: through two scans, MLPG and the loss);
  * the G update at 1e-6 (tests/test_torch_step.py's bound where |g| >
    1e-3; the clipped gradients of ones here are about 4e-3);
  * the full step's outputs by tests/test_torch_step.py's
    ``_check_outputs`` (rtol 1e-5), the JAX step given torch's Adagrad
    rule as there (the adversarial loss goes through the updated D).
"""

import contextlib
import gzip
import io
import json
import math
import os
import re
from os.path import join

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch

from gantts_tpu import hparams as jax_hparams
from gantts_tpu import kernels as jax_kernels
from gantts_tpu.core.masking import masked_mse_loss as jax_mse
from gantts_tpu.core.masking import sequence_mask as jax_mask
from gantts_tpu.core.paramgen import multi_stream_mlpg as jax_mlpg
from gantts_tpu.models.recurrent import StackedLSTM as JaxLSTM
from gantts_tpu.models.sru import SRU as JaxSRU
from gantts_tpu.models.sru import SRULayer as JaxSRULayer
from gantts_tpu.train import GanTrainer as JaxTrainer
from gantts_tpu.train import StepConfig as JaxConfig
from gantts_tpu.train.setup import init_models_and_states as jax_init
from gantts_tpu.train.step import TrainState as JaxState
from gantts_tpu_torch import convert, hparams
from gantts_tpu_torch.data import NPYDataSource
from gantts_tpu_torch.train import loop
from gantts_tpu_torch.train.__main__ import main as train_main
from test_torch_step import _check_outputs, _torch_rule
from tools import torch_host_pipeline_bench as pipeline_bench
from tools import torch_profile_step as profile_step
from tools import torch_trace_report as report

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, H, K = 2, 32, 16, 2
GEN = dict(hparams.tts_acoustic.generator_params, num_hidden=2,
           hidden_dim=H, dropout=0.0, rnn_dropout=0.0)
DISC = dict(hparams.tts_acoustic.discriminator_params, num_hidden=2,
            hidden_dim=8, dropout=0.0)
TINY = f"generator_params={GEN!r},discriminator_params={DISC!r}"
FWD_ATOL, REL, GRAD_REL, UPDATE_ATOL = 1e-5, 1e-5, 1e-4, 1e-6


# ---- the trace report on hand-written traces -------------------------------

GEMM = ("void proj_gemm_f32<F32Tile<128, 256, 8, 16> >(float const*, float "
        "const*, float*, int, int, int)")
GEMM_2 = "void proj_gemm_f32<F32Tile<64, 128, 4, 8> >(float const*, int)"
SCAN = "void sru_fwd_scan_kernel<float, true>(float const*, float*, int)"
ANON = ("void at::native::(anonymous namespace)::fill_kernel<(anonymous "
        "namespace)::Op>(int, float*)")
OURS = ("void (anonymous namespace)::proj_gemm_f32<(anonymous namespace)::"
        "F32Tile<8, 16, 4, 2> >(float const*, float const*, float*, int)")
GEMV = ("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, "
        "int, float>(float const*)")
NVJET = "nvjet_tst_128x64_64x8_1x2_h_bz_TNT"
COPY = "Memcpy HtoD (Pinned -> Device)"


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 7,
            "ts": ts, "dur": dur, "args": {}}


def _events(device=True):
    """Two dispatches (1 + 2 steps) over 300 us, with their device mirrors,
    a host op, a flow and a metadata event; device events (us): GEMM 10-40,
    SCAN 35-45, GEMM_2 50-70, COPY 1-4, ANON 200-204, GEMV 205-207, NVJET
    220-226, a fill 240-241."""
    ev = [{"ph": "M", "name": "process_name", "pid": 1,
           "args": {"name": "python"}},
          _x("user_annotation", "gan_dispatch:1", 0, 100),
          _x("user_annotation", "gan_dispatch:2", 100, 200),
          _x("gpu_user_annotation", "gan_dispatch:1", 5, 90),
          _x("gpu_user_annotation", "gan_dispatch:2", 190, 60),
          _x("cpu_op", "aten::mm", 8, 50),
          {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 3, "pid": 1,
           "tid": 7, "ts": 9}]
    if device:
        ev += [_x("kernel", GEMM, 10, 30), _x("kernel", SCAN, 35, 10),
               _x("kernel", GEMM_2, 50, 20), _x("gpu_memcpy", COPY, 1, 3),
               _x("kernel", ANON, 200, 4), _x("kernel", GEMV, 205, 2),
               _x("kernel", NVJET, 220, 6),
               _x("gpu_memset", "Memset (Device)", 240, 1)]
    return ev


def _write(path, events):
    data = {"schemaVersion": 1, "traceEvents": events}
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            json.dump(data, f)
    else:
        with open(path, "w") as f:
            json.dump(data, f)
    return path


def _run_main(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return out.getvalue(), result


@pytest.mark.parametrize("name, want", [
    (GEMM, "proj_gemm_f32"), (GEMM_2, "proj_gemm_f32"),
    (SCAN, "sru_fwd_scan_kernel"),
    (ANON, "at::native::fill_kernel"), (OURS, "proj_gemm_f32"),
    (GEMV, "internal::gemvx::kernel"), (NVJET, NVJET),
    ("void linear_recurrence_bwd_kernel(float const*, int)",
     "linear_recurrence_bwd_kernel")])
def test_function_name_strips_templates_and_parameters(name, want):
    assert report.function_name(name) == want


@pytest.mark.parametrize("suffix", [".json", ".json.gz"])
def test_report_reads_a_trace(tmp_path, suffix):
    """Categories by function name (copies and fills by their own), per
    step over the 3 steps of the dispatch annotations; the host ranges'
    device mirrors are no device work; busy (the union) <= the sum; the
    wall is the events' extent."""
    path = _write(str(tmp_path / f"trace{suffix}"), _events())
    events = report.load_events(path)
    r = report.read(events)
    assert r.steps == 3 == report.dispatch_steps(events)
    want_ms = {"proj_gemm_f32": 50, "sru_fwd_scan_kernel": 10, COPY: 3,
               "at::native::fill_kernel": 4,
               "internal::gemvx::kernel": 2, NVJET: 6,
               "Memset (Device)": 1}
    assert set(r.ms) == set(want_ms)
    for k, us in want_ms.items():
        assert r.ms[k] == pytest.approx(us / 1e3 / 3)
    assert r.n["proj_gemm_f32"] == pytest.approx(2 / 3)
    assert r.n[COPY] == pytest.approx(1 / 3)
    dev = report.device_events(events)
    assert len(dev) == 8
    assert not any("gan_dispatch" in e["name"] for e in dev)
    # GEMM and SCAN overlap by 5 us
    assert r.busy_ms == pytest.approx((76 - 5) / 1e3 / 3)
    assert r.summed_ms == pytest.approx(76 / 1e3 / 3)
    assert r.busy_ms <= r.summed_ms
    assert r.wall_ms == pytest.approx(300 / 1e3 / 3)
    assert r.idle == pytest.approx(1 - 71 / 300)
    assert report.device_ms(path) == pytest.approx(r.busy_ms)
    assert report.device_ms(events, steps=1) == pytest.approx(71 / 1e3)
    assert report.kernel_launches(events) == dict(
        {k: 0 for k in report.KERNEL_FUNCTIONS}, sru_proj_gemm=2,
        sru_fwd_scan=1)
    groups = dict(report.group_ms({e["name"]: e["dur"] for e in dev}))
    assert groups["sru_proj_gemm"] == 50 and groups["sru_fwd_scan"] == 10
    assert groups["library GEMMs (dx, dW, D, head, MLPG)"] == 6
    assert groups["the rest"] == 3 + 4 + 2 + 1


def test_report_reads_a_named_range():
    """With ``span``, the wall is that host range, and device events
    outside it are not read (the profile tool's priming call)."""
    events = _events() + [_x("user_annotation", "calls", 100, 200)]
    r = report.read(events, steps=2, span="calls")
    assert r.wall_ms == pytest.approx(200 / 1e3 / 2)
    assert set(r.ms) == {"at::native::fill_kernel", "internal::gemvx::kernel",
                         NVJET, "Memset (Device)"}
    assert r.busy_ms == pytest.approx(13 / 1e3 / 2)
    assert report.device_ms(events, 2, span="calls") == \
        pytest.approx(r.busy_ms)
    with pytest.raises(report.NoDeviceEvents):
        report.read(events + [_x("user_annotation", "idle", 400, 10)], 1,
                    span="idle")
    with pytest.raises(ValueError, match="no host range"):
        report.read(events, 1, span="missing")


def test_report_command_line(tmp_path):
    """The newest trace of a directory; the table; --steps; --raw."""
    old = _write(str(tmp_path / "old.json"), _events(device=False))
    os.utime(old, (1, 1))
    os.makedirs(tmp_path / "sub")
    path = _write(str(tmp_path / "sub" / "trace_epoch2.json.gz"), _events())
    assert report.trace_file(str(tmp_path)) == path
    text, _ = _run_main(report.main, [str(tmp_path)])
    assert "steps traced: 3 (from the dispatch annotations)" in text
    assert "device busy 0.024 ms, device events summed 0.025 ms" in text
    assert "idle share 0.7633" in text
    row = next(line for line in text.splitlines()
               if line.startswith("proj_gemm_f32"))
    assert row.split()[1:] == ["0.017", "0.67"]
    assert "void" not in text and "F32Tile" not in text
    text, _ = _run_main(report.main, [path, "--steps", "1", "--top", "2"])
    assert "steps traced: 1 (from the --steps)" in text
    assert "(other)" in text
    text, _ = _run_main(report.main, [path, "--raw", "--top", "3"])
    lines = text.splitlines()[1:]
    assert len(lines) == 3 and GEMM in lines[0] and GEMM_2 in lines[1]


def test_report_refuses_a_trace_without_device_events(tmp_path):
    path = _write(str(tmp_path / "cpu.json"), _events(device=False))
    with pytest.raises(SystemExit, match="no device events"):
        _run_main(report.main, [path])
    with pytest.raises(report.NoDeviceEvents):
        report.device_ms(path)
    no_steps = [e for e in _events() if "gan_dispatch" not in e["name"]]
    with pytest.raises(ValueError, match="give the steps"):
        report.read(no_steps)
    assert report.read(no_steps, steps=2).steps == 2


# ---- the dispatch annotation in a trace of the command line ---------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    import chip_smoke

    d = str(tmp_path_factory.mktemp("acoustic"))
    chip_smoke.write_acoustic_corpus(d, num=14, lin_dim=30, mgc_dim=20,
                                     frames=(80, 221))
    return d


def _cli(corpus, ck, *extra):
    gp = dict(hparams.tts_acoustic.generator_params, num_hidden=1,
              hidden_dim=16, bidirectional=False)
    dp = dict(hparams.tts_acoustic.discriminator_params, num_hidden=1,
              hidden_dim=8)
    argv = [join(corpus, "X_acoustic"), join(corpus, "Y_acoustic"),
            "--hparams_name=tts_acoustic",
            f"--hparams=nepoch=2,batch_size=4,stream_sizes=[60, 3, 1, 3],"
            f"order=20,generator_params={gp!r},"
            f"discriminator_params={dp!r}", f"--checkpoint-dir={ck}",
            f"--log-event-path={ck}/log", "--device=cpu", "--w_d=1", *extra]
    with contextlib.redirect_stdout(io.StringIO()):
        assert train_main(argv) == 0
    with open(join(ck, "log", "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_steps_inferred_from_a_cli_trace(corpus, tmp_path):
    """The --profile-dir trace of epoch 2 (CPU) holds one dispatch
    annotation a step, train and test: the report infers the epoch's steps.
    With the profile, the run logs the same values (the wall-clock series
    apart), bit for bit."""
    prof = str(tmp_path / "prof")
    rows = _cli(corpus, str(tmp_path / "a"), f"--profile-dir={prof}")
    steps = sum(-(-len(NPYDataSource(join(corpus, "X_acoustic"),
                                     train=phase == "train").collect_files())
                  // 4) for phase in ("train", "test"))
    events = report.load_events(prof)
    assert report.trace_file(prof).endswith("trace_epoch2.json")
    assert report.dispatch_steps(events) == steps
    assert {e["name"] for e in events if e.get("cat") == "user_annotation"
            } >= {f"{loop.DISPATCH_SPAN}:1"}
    with pytest.raises(report.NoDeviceEvents):
        report.read(events)
    plain = _cli(corpus, str(tmp_path / "b"))
    timing = ("frames_per_sec", "epoch_seconds")
    a, b = ([(r["tag"], r["step"], r["value"]) for r in rs
             if not r["tag"].endswith(timing)] for rs in (rows, plain))
    assert a == b and a


# ---- torch_profile_step's components against the JAX package -------------

def _jax_hp(compute_dtype="float32"):
    """tools/profile_step.py's configuration, made small as TINY makes the
    port's."""
    hp = jax_hparams.tts_acoustic.copy()
    hp.parse(TINY)
    hp.compute_dtype = compute_dtype
    hp.mlpg_impl = "dense"
    hp.generator_params.update(in_dim=profile_step.LIN_DIM,
                               out_dim=profile_step.OUT_DIM)
    hp.discriminator_params.update(in_dim=profile_step.DISC_IN)
    return hp


def _host(tree):
    return jax.tree_util.tree_map(np.array, tree)


class _Both:
    """The port's components and the JAX package's models, variables and
    inputs, with the same weights."""

    def __init__(self):
        hp = profile_step.make_hp(overrides=TINY)
        self.comps = profile_step.build_components(
            hp, B, T, "cpu", layer_ablation=True, steps_per_dispatch=K)
        self.hp = jhp = _jax_hp()
        a = self.arrays = {k: jnp.asarray(v)
                           for k, v in self.comps.arrays.items()}
        x, lengths = a["x"], a["lengths"]
        (self.model_g, self.model_d, self.tx_g, self.tx_d, self.gs,
         self.ds) = jax_init(jhp, seed=0)
        gp = jhp.generator_params
        self.sru = JaxSRU(H, gp["num_hidden"], gp["bidirectional"], 0.0, 0.0,
                          gp["use_relu"], compute_dtype="float32")
        self.layer = JaxSRULayer(H, gp["use_relu"], "float32")
        self.lstm = JaxLSTM(H, 3, bidirectional=True,
                            compute_dtype="float32")
        self.vars = dict(
            generator=self.gs.params, discriminator=self.ds.params,
            sru=self.sru.init(jr.PRNGKey(0), x, lengths),
            layer=self.layer.init(jr.PRNGKey(1), a["xe"], lengths),
            lstm=self.lstm.init(jr.PRNGKey(0), x, lengths))
        self.vars = _host(self.vars)
        for name, v in self.vars.items():
            self.comps.modules[name].load_state_dict(
                convert.flax_to_torch(v), strict=True)

    def grads_match(self, name, got, ref_tree):
        ref = convert.flax_to_torch(_host(ref_tree))
        names = [n for n, _ in self.comps.modules[name].named_parameters()]
        assert sorted(names) == sorted(ref) and len(got) == len(names)
        for n, g in zip(names, got):
            r = ref[n].numpy()
            err = np.abs(g.numpy() - r).max() / max(np.abs(r).max(), 1e-12)
            assert err <= GRAD_REL, (name, n, err)


@pytest.fixture(scope="module")
def both():
    return _Both()


def _close(got, ref, atol=FWD_ATOL):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= atol


def test_components_are_the_jax_tools_rows(both):
    """The JAX tool's rows, in its order ("(wall)" and "(device)" are one
    row's columns here), and the replayed full step."""
    with open(join(REPO, "tools", "profile_step.py")) as f:
        jax_rows = re.findall(r'rows\.append\(\("([^"]+)"', f.read())
    jax_rows = [re.sub(r" \((wall|device)\)$", "", n) for n in jax_rows]
    jax_rows = list(dict.fromkeys(jax_rows))
    jax_rows.remove("trunk matmul bound f+b (3x)")  # derived from fwd
    names = [c.name for c in both.comps.rows]
    assert names == jax_rows[:1] + [f"full G+D step, {K} a replay"] + \
        jax_rows[1:]


def test_forward_components_match_jax(both):
    """G, D, MLPG, the SRU trunk, one SRULayer, its projection, the scan
    from u, the concat and the LSTM trunk, forward."""
    a, v, jhp = both.arrays, both.vars, both.hp
    x, y, lengths, R = a["x"], a["y"], a["lengths"], a["R"]
    streams = (tuple(jhp.stream_sizes), tuple(jhp.has_dynamic_features))
    run = both.comps.row
    _close(run("G forward")(), both.model_g.apply(
        v["generator"], x, lengths, deterministic=True))
    _close(run("D forward")(), both.model_d.apply(
        v["discriminator"], a["xd"], lengths, deterministic=True))
    _close(run("MLPG fwd")(), jax_mlpg(y, R, *streams))
    _close(run("SRU trunk fwd")(), both.sru.apply(
        v["sru"], x, lengths, deterministic=True))
    _close(run("1 SRULayer fwd")(), both.layer.apply(
        v["layer"], a["xe"].astype(jnp.float32), lengths))
    _close(run("1 layer proj matmul fwd")(),
           a["xe"].reshape(-1, 2 * H) @ a["w1"])
    bias4 = jnp.zeros(4 * H, jnp.float32)
    _close(run("1 fused kernel fwd")(), jax_kernels.fused_sru_layer(
        a["u1"], lengths, bias4=bias4, reverse=False, use_relu=1))
    _close(run("1 layer fwd/bwd concat")(),
           jnp.concatenate([a["h2"], a["h2"]], axis=-1) * 1.0)
    _close(run("LSTM trunk 3x fwd")(), both.lstm.apply(
        v["lstm"], x, lengths, deterministic=True))
    got = float(run("trunk matmul bound fwd")())
    ref = float(sum(jnp.sum(a["xs_mm"] @ a["ws_mm"][i]) for i in range(12)))
    assert abs(got - ref) <= REL * abs(ref)


def test_backward_components_match_jax(both):
    """G through the MGE loss, the SRU trunk, one SRULayer and the LSTM
    trunk: parameter gradients; the scan from u: its u-gradient."""
    a, v, jhp = both.arrays, both.vars, both.hp
    x, y, lengths, R = a["x"], a["y"], a["lengths"], a["R"]
    streams = (tuple(jhp.stream_sizes), tuple(jhp.has_dynamic_features))
    run = both.comps.row
    y_static_ref = jax_mlpg(y, R, *streams)
    mask = jax_mask(lengths, T)[..., None]

    def g_loss(p):
        yh = both.model_g.apply(p, x, lengths, deterministic=True)
        return jax_mse(jax_mlpg(yh, R, *streams), y_static_ref, mask=mask)
    both.grads_match("generator", run("G fwd+bwd (mge)")(),
                     jax.grad(g_loss)(v["generator"]))
    both.grads_match("sru", run("SRU trunk fwd+bwd")(), jax.grad(
        lambda p: jnp.sum(both.sru.apply(p, x, lengths,
                                         deterministic=True) ** 2))(v["sru"]))
    both.grads_match("layer", run("1 SRULayer fwd+bwd")(), jax.grad(
        lambda p: jnp.sum(both.layer.apply(
            p, a["xe"].astype(jnp.float32), lengths).astype(jnp.float32)
            ** 2))(v["layer"]))
    both.grads_match("lstm", run("LSTM trunk 3x fwd+bwd")(), jax.grad(
        lambda p: jnp.sum(both.lstm.apply(p, x, lengths, deterministic=True)
                          .astype(jnp.float32) ** 2))(v["lstm"]))
    bias4 = jnp.zeros(4 * H, jnp.float32)
    du = jax.grad(lambda uu: jnp.sum(jax_kernels.fused_sru_layer(
        uu, lengths, bias4=bias4, reverse=False, use_relu=1)
        .astype(jnp.float32) ** 2))(a["u1"])
    got = run("1 fused kernel fwd+bwd")().numpy()
    assert np.abs(got - np.asarray(du)).max() <= \
        GRAD_REL * np.abs(np.asarray(du)).max()


def test_g_update_matches_jax():
    """One G update from gradients of ones: the parameters move by the JAX
    package's Adagrad update (clip, weight decay; its eps inside the square
    root differs from torch's by lr eps / (2 g^2), about 3e-10 here)."""
    both = _Both()
    model = both.comps.modules["generator"]
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    both.comps.row("G optimizer update")()
    ones = jax.tree_util.tree_map(jnp.ones_like, both.gs.params)
    updates, _ = jax.jit(lambda g, st, p: both.tx_g.update(g, st, p))(
        ones, both.gs.opt_state, both.gs.params)
    ref = convert.flax_to_torch(_host(updates))
    for n, p in model.named_parameters():
        step = (p.detach() - before[n]).numpy()
        assert np.abs(step).max() > 1e-3, n
        assert np.abs(step - ref[n].numpy()).max() <= UPDATE_ATOL, n


def test_full_steps_match_jax():
    """The eager full step, then the K-step dispatch (K eager steps on the
    CPU), against K + 1 JAX steps from the same states."""
    both = _Both()
    jhp, a = both.hp, both.arrays
    tx_g = _torch_rule(jhp.optimizer_g, jhp.optimizer_g_params, both.tx_g)
    tx_d = _torch_rule(jhp.optimizer_d, jhp.optimizer_d_params, both.tx_d)
    jg = JaxState(both.gs.params, tx_g.init(both.gs.params))
    jd = JaxState(both.ds.params, tx_d.init(both.ds.params))
    out_dim = profile_step.OUT_DIM
    jtr = JaxTrainer(both.model_g, both.model_d, tx_g, tx_d,
                     JaxConfig.from_hparams(jhp, w_d=1.0, mse_w=0.0,
                                            mge_w=1.0, update_d=True,
                                            update_g=True),
                     np.zeros(out_dim, np.float32),
                     np.ones(out_dim, np.float32), windows=jhp.windows)
    step = jtr.step_fn(True)
    jouts = []
    for i in range(K + 1):
        jg, jd, jout, _ = step(jg, jd, None, a["x"], a["y"], a["lengths"],
                               a["R"], None, jnp.float32(1.0),
                               jax.random.PRNGKey(i))
        jouts.append(jout)
    n_frames = int(np.asarray(a["lengths"]).sum())
    _check_step(jouts[0], both.comps.row("full G+D step")(), n_frames)
    outs = both.comps.row(f"full G+D step, {K} a replay")()
    for i in range(K):
        _check_step(jouts[1 + i], {k: v[i] for k, v in outs.items()},
                    n_frames)


def _check_step(jout, out, n_frames):
    """``_check_outputs``, but for f0_rmse where the JAX step's is not a
    number: the tool's unit statistics put the V/UV threshold where no
    frame is voiced in both target and prediction, so the F0 error has no
    frame in either package."""
    if not np.isfinite(float(jout["f0_rmse"])):
        assert not np.isfinite(float(out["f0_rmse"]))
        jout = {k: v for k, v in jout.items() if k != "f0_rmse"}
        out = {k: v for k, v in out.items() if k != "f0_rmse"}
    _check_outputs(jout, out, n_frames)


# ---- both tools end to end --------------------------------------------------

def test_profile_step_end_to_end(tmp_path):
    """The command line at a tiny size on the CPU: every row of the JAX
    tool, timed by the host clock (no device column), the parameter count,
    frames/s, the rows in --json, and a trace of 3 full steps in
    --trace-dir, which the report refuses: it holds no device event."""
    trace_dir = str(tmp_path / "trace")
    text, res = _run_main(profile_step.main, [
        "--device", "cpu", "--hparams", TINY, "--frames", str(T), "--batch",
        str(B), "--layer-ablation", f"--steps-per-dispatch={K}",
        f"--trace-dir={trace_dir}", f"--json={tmp_path / 'rows.json'}"])
    with open(tmp_path / "rows.json") as f:
        assert json.load(f) == {k: v for k, v in res.items()
                                if k != "components"}
    with open(join(REPO, "tools", "profile_step.py")) as f:
        jax_rows = {re.sub(r" \((wall|device)\)$", "", n) for n in
                    re.findall(r'rows\.append\(\("([^"]+)"', f.read())}
    names = [r["name"] for r in res["rows"]]
    assert set(names) == jax_rows | {f"full G+D step, {K} a replay"}
    for r in res["rows"]:
        assert math.isfinite(r["wall_ms"]) and r["wall_ms"] > 0, r
        assert r["device_ms"] is None and r["launches"] == {}, r
        line = next(line for line in text.splitlines()
                    if line.startswith(r["name"] + " "))
        assert float(line.split()[-1]) == pytest.approx(r["wall_ms"],
                                                        abs=1e-3)
    assert res["rows"][names.index("trunk matmul bound f+b (3x)")][
        "wall_ms"] == pytest.approx(
            3 * res["rows"][names.index("trunk matmul bound fwd")]["wall_ms"])
    n_params = sum(p.numel() for p in
                   res["components"].modules["generator"].parameters())
    assert res["g_params"] == n_params
    assert f"G params: {n_params / 1e6:.1f}M   B={B} T={T}" in text
    assert "host ms" in text and "device ms" not in text
    assert "frames/sec, full G+D step:" in text and " device" not in \
        text.split("frames/sec")[1]
    events = report.load_events(trace_dir)
    assert report.dispatch_steps(events) == profile_step.TRACE_DIR_STEPS
    with pytest.raises(SystemExit, match="no device events"):
        _run_main(report.main, [trace_dir])


def test_host_pipeline_bench_end_to_end(tmp_path):
    """One measured epoch a setting on tests/make_synthetic_data.py's VC
    corpus, on the CPU: the JAX tool's JSON keys, finite values, every
    train batch one eager step."""
    from make_synthetic_data import make_vc

    d = str(tmp_path / "vc")
    with contextlib.redirect_stdout(io.StringIO()):
        make_vc(d, num=24, order=19)
    gp = dict(hparams.vc.generator_params, num_hidden=1, hidden_dim=16,
              static_dim=19)
    dp = dict(hparams.vc.discriminator_params, in_dim=19, num_hidden=1,
              hidden_dim=8)
    spec = (f"batch_size=4,order=19,stream_sizes=[57],generator_params="
            f"{gp!r},discriminator_params={dp!r}")
    text, out = _run_main(pipeline_bench.main, [
        join(d, "X"), join(d, "Y"), "--hparams", spec, "--epochs", "1",
        "--workers", "2", "--device", "cpu"])
    assert json.loads(text.strip().splitlines()[-1]) == out
    n_train = len(NPYDataSource(join(d, "X"), train=True).collect_files())
    assert out["metric"] == "streamed_epoch_throughput"
    assert out["workload"] == f"{n_train} utts, batch 4, vc"
    assert out["device"] == "cpu" and out["steps_per_dispatch"] == 1
    for key in ("num_workers_0", "num_workers_2"):
        row = out[key]
        assert set(row) >= {"median_epoch_s", "frames_per_sec"}
        assert all(math.isfinite(row[k]) and row[k] > 0
                   for k in ("median_epoch_s", "frames_per_sec"))
        assert row["steps_per_epoch"] == -(-n_train // 4)
        assert row["steps_in_replays_per_epoch"] == 0
    assert os.listdir(join(d, "X")) == os.listdir(join(d, "Y"))
    assert not any(f.startswith("data_") for f in os.listdir(join(d, "X")))
