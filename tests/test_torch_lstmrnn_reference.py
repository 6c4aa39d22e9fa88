"""The LSTMRNN acoustic generator against the benchmark's plain reference
(``perfbench/reference/lstmrnn.py``), on the CPU at a small size.

* The port's GAN step (the ``tts_acoustic`` bundle with ``LSTMRNN``: 2
  bidirectional layers of 32, 24 inputs, 16 outputs in the TTS stream
  layout [9, 3, 1, 3], batch 3 at natural lengths with padding, seeded
  random weights) driven by the benchmark's harness through ``train_loop``,
  against the reference's three steps: each step's losses, the first
  gradients and the parameters' change after step 3.
* The reference's LSTM stack against ``nn.LSTM(bidirectional=True)`` on
  packed sequences, in float64, forward and backward.
* ``perfbench/flops/lstmrnn.py`` against torch's FlopCounterMode on the
  port's model, and its bounds against the one-direction family's.
* The benchmark's readers in this cell: the flag design's share of the
  traced LSTM scans, and the scans' share of their bounds.
* The command line's ``--hparams`` override building the generator at the
  published widths: 35,536,059 parameters under the reference's names.
"""

import copy
import os
import sys
from os.path import dirname, join

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

REPO = dirname(dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
torch.set_num_threads(1)

from perfbench import check, corpus, harness  # noqa: E402
from perfbench.flops import in2out_rnn as uni_flops  # noqa: E402
from perfbench.flops import lstmrnn as flops  # noqa: E402
from perfbench.reference import lstmrnn as ref  # noqa: E402

PUBLISHED = dict(in_dim=425, out_dim=187, num_hidden=6, hidden_dim=512,
                 bidirectional=True, dropout=0.2, last_sigmoid=False)
PARAMETERS = 35536059


def tiny_config():
    """The benchmark's tts_lstm configuration at the tests' size."""
    cfg = copy.deepcopy(harness.load_json(
        join(REPO, "perfbench", "configs", "tts_lstm.json")))
    hp = cfg["hparams"]
    hp["stream_sizes"] = [9, 3, 1, 3]
    hp["generator_params"].update(in_dim=24, out_dim=16, num_hidden=2,
                                  hidden_dim=32)
    hp["discriminator_params"].update(in_dim=24 + 3 - 2, hidden_dim=8)
    hp["batch_size"] = 3
    cfg["corpus"].update(question_dim=16, frame_feature_dim=8)
    return cfg


TRAFFIC = {"utterances": 30, "frames": {
    "kind": "lognormal", "median": 40, "sigma_log": 0.3, "min": 16,
    "max": 80, "order_seed": 0}}


# Both sides run float32 on the CPU with the same masks, weights and
# batches; they differ in the order of their sums only (the reference adds
# both directions' recurrent products in one batched product and the bias
# into x_p first), about 1e-7 of each number.  The first update moves each
# element by the learning rate times the sign of its gradient, so an
# element whose gradient lies within rounding of 0 can move either way: the
# change is judged as check.py judges it, by leaf norms, leaving out the
# leaves whose first gradient is under 1e-3 of the median leaf's.
LOSS_RTOL = 1e-5
GRAD_GAP = 1e-5
CHANGE_GAP = 1e-5


@pytest.mark.parametrize("seed", [3, 2147483911])
def test_the_ports_gan_step_is_the_references(tmp_path, seed):
    cfg = tiny_config()
    sd = harness.seeds(seed)
    dev = torch.device("cpu")
    raw = corpus.make(cfg, TRAFFIC, sd["corpus"], dev)
    with harness.program_output_to_stderr():
        prog, book, _, record, _ = harness.drive(cfg, raw, sd, dev,
                                                 str(tmp_path))
    trained = book.batches([1], "train")
    assert len(trained) == 3
    # natural lengths, padded to the bucket
    assert any(min(f[4]) < f[3] for f in trained)
    assert type(prog.gstate.model).__name__ == "LSTMRNN"
    family, _ = harness.family(cfg)
    assert family is ref
    weights = harness.weights_of(cfg, sd, dev)
    reference = check.reference_record(
        family, harness.hparams_of(cfg), cfg["run"], raw, weights,
        sd["loop"], dev)
    for p, r in zip(record["losses"], reference["losses"]):
        for k in check.LOSSES:
            assert abs(p[k] - r[k]) <= LOSS_RTOL * abs(r[k]), (k, p, r)
    values = check.readings(record, reference)
    assert values["grad_gap"] < GRAD_GAP, check.detail(record, reference)
    assert values["change_gap"] < CHANGE_GAP, check.detail(record,
                                                           reference)
    # the LSTM's leaves are all there and all moved
    names = {k for k, _, _ in ref.param_specs(harness.hparams_of(cfg))}
    assert {k[2:] for k in record["grad"] if k[:2] == "G."} == names
    assert min(v for k, v in record["change"].items() if k[:2] == "G.") > 0


def _packed_lstm(P, H, L, dtype):
    """nn.LSTM with the weight table's values."""
    D = P["lstm.l0_fwd.w_ih"].shape[0]
    net = torch.nn.LSTM(D, H, L, bidirectional=True, batch_first=True,
                        dtype=dtype)
    with torch.no_grad():
        for i in range(L):
            for way, suffix in (("fwd", ""), ("bwd", "_reverse")):
                p = f"lstm.l{i}_{way}."
                getattr(net, f"weight_ih_l{i}{suffix}").copy_(
                    P[p + "w_ih"].t())
                getattr(net, f"weight_hh_l{i}{suffix}").copy_(
                    P[p + "w_hh"].t())
                getattr(net, f"bias_ih_l{i}{suffix}").copy_(P[p + "b_ih"])
                getattr(net, f"bias_hh_l{i}{suffix}").copy_(P[p + "b_hh"])
    return net


def test_the_reference_is_nn_lstm_on_packed_sequences():
    from torch.nn.utils.rnn import pack_padded_sequence, pad_packed_sequence

    gp = dict(in_dim=24, hidden_dim=32, num_hidden=2, bidirectional=True,
              dropout=0.2, out_dim=16)
    H, L, T = gp["hidden_dim"], gp["num_hidden"], 13
    dt = torch.float64
    g = torch.Generator().manual_seed(0)
    P = {name: (torch.rand(shape, generator=g, dtype=dt) * 2 - 1) * bound
         for name, shape, bound in ref.param_specs({"generator_params": gp})}
    lengths = torch.tensor([13, 7, 1, 10])
    x = torch.randn(4, T, gp["in_dim"], generator=g, dtype=dt)
    cot = torch.randn(4, T, 2 * H, generator=g, dtype=dt)

    net = _packed_lstm(P, H, L, dt)
    xa = x.clone().requires_grad_(True)
    packed = pack_padded_sequence(xa, lengths, batch_first=True,
                                  enforce_sorted=False)
    want, _ = pad_packed_sequence(net(packed)[0], batch_first=True,
                                  total_length=T)
    (want * cot).sum().backward()

    Pr = {k: v.clone().requires_grad_(True) for k, v in P.items()}
    xb = x.clone().requires_grad_(True)
    got = ref.trunk(Pr, xb, lengths, None, gp)
    (got * cot).sum().backward()

    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    torch.testing.assert_close(xb.grad, xa.grad, rtol=0, atol=1e-12)
    for i in range(L):
        for way, suffix in (("fwd", ""), ("bwd", "_reverse")):
            p = f"lstm.l{i}_{way}."
            for ours, theirs, tr in (("w_ih", "weight_ih", True),
                                     ("w_hh", "weight_hh", True),
                                     ("b_ih", "bias_ih", False),
                                     ("b_hh", "bias_hh", False)):
                grad = getattr(net, f"{theirs}_l{i}{suffix}").grad
                torch.testing.assert_close(
                    Pr[p + ours].grad, grad.t() if tr else grad, rtol=0,
                    atol=1e-11, msg=p + ours)

    # a row of length 0 (a batch's padding row) is 0 and changes no other
    zero = ref.trunk(P, torch.cat([x, x[:1]]), torch.cat(
        [lengths, torch.tensor([0])]), None, gp)
    assert not zero[4].any()
    torch.testing.assert_close(zero[:4], want.detach(), rtol=0, atol=1e-12)


def test_the_reversal_reverses_each_rows_valid_frames():
    idx = ref.reversal(torch.tensor([3, 1, 0]), 4)
    assert idx.t().tolist() == [[2, 1, 0, 3], [0, 1, 2, 3], [0, 1, 2, 3]]
    assert torch.equal(idx.gather(0, idx), torch.arange(4)[:, None].expand(
        4, 3))


def _tiny_hp():
    return harness.hparams_of(tiny_config())


@pytest.mark.parametrize("train", [False, True])
def test_the_generators_operations_are_counted(train):
    from gantts_tpu_torch.models import create_model

    hp = _tiny_hp()
    gp = hp["generator_params"]
    G = create_model("LSTMRNN", compute_dtype="float32", device="cpu",
                     generator=torch.Generator().manual_seed(0), **gp)
    B, T = 3, 24
    x = torch.randn(B, T, gp["in_dim"])
    lengths = torch.full((B,), T, dtype=torch.int32)

    with FlopCounterMode(display=False) as m:
        with torch.set_grad_enabled(train):
            y = G(x, lengths)
            if train:
                y.sum().backward()
    assert m.get_total_flops() == flops.generator(hp, B * T, train, rows=B)


@pytest.mark.parametrize("train", [False, True])
def test_the_step_counts_and_bounds_hold_together(train):
    hp = _tiny_hp()
    gp = hp["generator_params"]
    H, L = gp["hidden_dim"], gp["num_hidden"]
    T, lengths = 32, [32, 20, 7]
    frames = len(lengths) * T
    rec = L * 2 * 2 * H * 4 * H
    # the GEMMs carry every product but the recurrent ones in the scans
    assert flops.gemm_flops(hp, T, lengths, train) + frames * rec * (
        2 if train else 1) == flops.step_flops(hp, T, lengths, train, True)
    assert flops.step_flops(hp, T, lengths, train, False) < \
        flops.step_flops(hp, T, lengths, train, True)
    # two directions a layer are twice the one-direction family's bound
    uni = copy.deepcopy(hp)
    uni["generator_params"].update(bidirectional=False, static_dim=4)
    assert flops.recurrence_seconds(hp, T, lengths, train) == \
        pytest.approx(2 * uni_flops.recurrence_seconds(uni, T, lengths,
                                                       train), rel=1e-12)


def test_the_published_widths_count_the_issue_s_parameters():
    specs = ref.param_specs({"generator_params": PUBLISHED})
    assert sum(int(np.prod(shape)) for _, shape, _ in specs) == PARAMETERS


def _kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


# a traced epoch's device events: two flag scans, a cooperative and a
# cluster one, and kernels that are not LSTM scans
SCAN_EVENTS = [
    _kernel("void lstm_fwd_flag_kernel<8, 4>(float const*)", 0, 300.0),
    _kernel("void lstm_bwd_flag_kernel<8, 4>(float const*)", 400, 500.0),
    _kernel("void (anonymous namespace)::lstm_fwd_kernel<float>(float "
            "const*)", 1000, 60.0),
    _kernel("void lstm_bwd_cluster_kernel<16>(__nv_bfloat16 const*)", 1100,
            40.0),
    _kernel("void (anonymous namespace)::proj_gemm_f32<F32Tile<128, 256, "
            "64, 32> >(float const*)", 2000, 900.0),
    {"ph": "X", "cat": "cpu_op", "name": "lstm_fwd_flag_kernel", "ts": 0,
     "dur": 5000.0}]


@pytest.mark.parametrize("events, share", [
    (SCAN_EVENTS, 50.0),
    (SCAN_EVENTS[:2], 100.0),
    (SCAN_EVENTS[2:4], 0.0),
    (SCAN_EVENTS[4:], None)])
def test_the_flag_share_reads_the_lstm_kernels_in_the_trace(events, share):
    read = harness.metric_reader("lstm.flag_share")
    got = read({"trace": events})
    assert got == share if share is None else got == pytest.approx(share)
    assert read({"trace": None}) is None


def test_the_recurrence_roofline_reads_the_bidirectional_scans():
    """In this cell the recurrence kernels are the LSTM scans, each over
    both directions of a layer, against the family's two-direction
    bounds."""
    hp = _tiny_hp()
    T, lengths = 64, np.array([64, 40, 0])
    book = harness.Book()
    book.fetches = [(3, "train", 0.0, T, lengths),
                    (3, "test", 0.0, T, lengths),
                    (2, "train", 0.0, T, lengths)]
    ctx = dict(trace=SCAN_EVENTS[:2] + SCAN_EVENTS[4:], book=book,
               trace_epoch=3, hp=hp, ops=flops)
    least = flops.recurrence_seconds(hp, T, lengths, True) + \
        flops.recurrence_seconds(hp, T, lengths, False)
    read = harness.metric_reader("recurrence_roofline")
    assert read(ctx) == pytest.approx(100.0 * least / 800e-6)
    assert read(dict(ctx, trace=None)) is None
    assert read(dict(ctx, trace=SCAN_EVENTS[4:])) is None


def _full_width_corpus(root, n=11):
    """n utterances of 24-40 frames, 425 linguistic and 187 acoustic dims
    (NPYDataSource keeps the last 5 for evaluation)."""
    rs = np.random.RandomState(0)
    for sub in ("X_acoustic", "Y_acoustic"):
        os.makedirs(join(root, sub))
    for i in range(n):
        T = int(rs.randint(24, 41))
        np.save(join(root, "X_acoustic", f"utt_{i:04d}.npy"),
                (rs.rand(T, 425) > 0.7).astype(np.float32))
        np.save(join(root, "Y_acoustic", f"utt_{i:04d}.npy"),
                rs.randn(T, 187).astype(np.float32))


def test_the_cli_builds_the_published_widths(tmp_path, capsys):
    """The command line with the tts_acoustic bundle and the generator
    override that the benchmark's configuration states trains an epoch of
    LSTMRNN at the published widths: 35,536,059 generator parameters under
    the reference's names and shapes, the discriminator on 483 inputs."""
    from gantts_tpu_torch.train.__main__ import main

    _full_width_corpus(str(tmp_path))
    gp = ", ".join(f"'{k}': {v!r}" for k, v in PUBLISHED.items())
    ckpt = str(tmp_path / "ck")
    main([str(tmp_path / "X_acoustic"), str(tmp_path / "Y_acoustic"),
          "--hparams_name=tts_acoustic",
          f"--hparams=nepoch=1,batch_size=4,generator=LSTMRNN,"
          f"generator_params={{{gp}}}", "--w_d=1",
          f"--checkpoint-dir={ckpt}", f"--log-event-path={tmp_path}/log",
          "--disable-slack", "--device", "cpu"])
    capsys.readouterr()
    state = torch.load(join(ckpt, "checkpoint_epoch1_Generator.pth"),
                       weights_only=True)["state_dict"]
    assert sum(v.numel() for v in state.values()) == PARAMETERS
    specs = ref.param_specs({"generator_params": PUBLISHED})
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(shape) for k, shape, _ in specs}
    assert all(torch.isfinite(v).all() for v in state.values())
    disc = torch.load(join(ckpt, "checkpoint_epoch1_Discriminator.pth"),
                      weights_only=True)["state_dict"]
    assert disc["layers_0.kernel"].shape == (483, 256)


def test_the_benchmark_states_the_cell_as_the_issue_gives_it():
    bench = harness.load_json(join(REPO, "BENCHMARK.json"))
    cell, config, traffic, end_to_end, per_layer = harness.find_cell(
        "tts_lstm.fixed512")
    assert (cell["chips"], cell["traffic"]) == (1, "fixed512")
    assert config["generator_parameters"] == PARAMETERS
    assert config["hparams"]["generator_params"] == PUBLISHED
    assert config["reduced"] == []
    acoustic = harness.load_json(join(REPO, "perfbench", "configs",
                                      "tts_acoustic.json"))
    assert {k: v for k, v in config["hparams"].items()
            if k not in ("generator", "generator_params")} == {
        k: v for k, v in acoustic["hparams"].items()
        if k not in ("generator", "generator_params")}
    # the accepted metrics of both TTS and VC cells, and the flag share
    assert {m["name"] for m in per_layer} == {
        m["name"] for m in bench["per_layer"]}
    assert [m["name"] for m in per_layer if m["workloads"] == [
        "tts_lstm.fixed512"]] == ["lstm.flag_share"]
    assert {m["name"] for m in end_to_end} == {
        m["name"] for m in bench["end_to_end"]}
    assert traffic["utterances"] == 1132
