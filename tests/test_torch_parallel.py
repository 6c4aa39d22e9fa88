"""The port's data parallelism (gantts_tpu_torch/parallel/) against the JAX
package's, on the CPU.

The port's ranks are processes: ``parallel.spawn`` starts gloo groups of 2
and 4 worker processes (rendezvous through a file in ``tmp_path``), which
run the rank programs of ``torch_parallel_workers.py`` (torch and the port
only).  The JAX package runs in this process on the 8-device CPU mesh that
``conftest.py`` gives it.  Both start from the same weights (JAX init,
converted); the JAX side takes torch's Adagrad rule (see
tests/test_torch_step.py), dropout is off but where named.

Tolerances are tests/test_parallel.py's: scalars rtol 2e-4 / atol 1e-5,
parameters atol 5e-5, the time-sharded MLPG 5e-5, the loop's per-leaf
parameter means rtol 5e-4 / atol 1e-6.  The port's DP step against its own
single-process step differs by summation order alone: scalars rtol 1e-5,
gradients 1e-5 of each tensor's largest entry.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from os.path import dirname, join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as W
from gantts_tpu import hparams as jax_hparams
from gantts_tpu.core.fast_mlpg import unit_variance_mlpg_stencil as jax_stencil
from gantts_tpu.core.paramgen import unit_variance_mlpg as jax_mlpg
from gantts_tpu.parallel import DataParallelGanTrainer as JaxDP
from gantts_tpu.parallel import make_mesh as jax_mesh
from gantts_tpu.parallel import pad_batch_to_devices as jax_pad
from gantts_tpu.parallel import time_sharded_unit_variance_mlpg as jax_sp
from gantts_tpu.train import GanTrainer as JaxTrainer
from gantts_tpu.train import StepConfig as JaxConfig
from gantts_tpu.train import loop as jax_loop
from gantts_tpu.train.setup import init_models_and_states as jax_init
from gantts_tpu.train.step import TrainState as JaxState
from gantts_tpu_torch import convert, parallel
from gantts_tpu_torch.models.common import BatchRows, batch_view, rand
from gantts_tpu_torch.train.__main__ import num_devices, steps_per_dispatch
from test_torch_step import _torch_rule

REPO = dirname(dirname(os.path.abspath(__file__)))
torch.set_num_threads(1)

SCALAR_RTOL, SCALAR_ATOL, PARAM_ATOL = 2e-4, 1e-5, 5e-5
SELF_RTOL, GRAD_TOL = 1e-5, 1e-5
MLPG_TOL = 5e-5
ADV_W = 0.7


def _stats(config):
    out = 27 if config == "vc" else 187
    mean, std = np.zeros(out, np.float32), np.ones(out, np.float32)
    if config == "sru":
        mean[183] = 2.0  # V/UV around 2: voiced frames, a finite f0_rmse
    return mean, std


def _batch(config, B):
    if config == "vc":
        x, y, lengths = W.make_batch(B, 64, 27, 27)
    else:
        x, y, lengths = W.make_batch(B, 64, 30, 187)
    return x, y, lengths


def _jax_states(jhp):
    model_g, model_d, tx_g, tx_d, jg, jd = jax_init(jhp, seed=0)
    tx_g = _torch_rule(jhp.optimizer_g, jhp.optimizer_g_params, tx_g)
    tx_d = _torch_rule(jhp.optimizer_d, jhp.optimizer_d_params, tx_d)
    jg = JaxState(jg.params, tx_g.init(jg.params))
    jd = JaxState(jd.params, tx_d.init(jd.params))
    return (model_g, model_d, tx_g, tx_d), jg, jd


def _jax_init_params(config):
    """The JAX package's initial (G, D) params of a config, on the host
    (seed 0: the same as ``_jax_step``'s)."""
    _, jg, jd = _jax_states(W.CONFIGS[config](jax_hparams))
    return jax.tree_util.tree_map(np.array, (jg.params, jd.params))


def _jax_step(config, B, mesh):
    """One JAX training step on the config's batch, single-device or on an
    8-device mesh: (initial params, outputs, updated params), on the
    host."""
    jhp = W.CONFIGS[config](jax_hparams)
    models, jg, jd = _jax_states(jhp)
    p0 = jax.tree_util.tree_map(np.array, (jg.params, jd.params))
    cfg = JaxConfig.from_hparams(jhp, **W.STEP_KW)
    x, y, lengths = _batch(config, B)
    R = W.mlpg_matrix(64)
    if mesh is None:
        tr = JaxTrainer(*models, cfg, *_stats(config))
        args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(lengths),
                jnp.asarray(R))
    else:
        tr = JaxDP(*models, cfg, *_stats(config), mesh=mesh)
        jg, jd = tr.place_states(jg, jd)
        xs, ys, ls, _ = tr.put_batch(x, y, lengths)
        args = (xs, ys, ls, tr.put_replicated(R))
    jg, jd, out, _ = tr.step_fn(True)(
        jg, jd, None, *args[:3], args[3], None, jnp.float32(ADV_W),
        jax.random.PRNGKey(7))
    out = {k: float(v) for k, v in jax.device_get(out).items()}
    params = jax.tree_util.tree_map(np.array, (jg.params, jd.params))
    return p0, out, params


def _step_case(config, B, p0):
    x, y, lengths = _batch(config, B)
    mean, std = _stats(config)
    return dict(config=config, g=convert.flax_to_torch(p0[0]),
                d=convert.flax_to_torch(p0[1]), x=x, y=y, lengths=lengths,
                R=W.mlpg_matrix(64), Y_mean=mean, Y_std=std, adv_w=ADV_W)


def _loop_batches():
    """_loop_workload's batches: B=8 at T = 64, 96, 64, and a test batch."""
    rs = np.random.RandomState(0)

    def batch(T):
        x = rs.rand(8, T, 30).astype(np.float32)
        y = rs.rand(8, T, 187).astype(np.float32)
        lengths = np.r_[rs.randint(T // 2, T, 7), T].astype(np.int32)
        return x, y, lengths
    return {"train": [batch(64), batch(96), batch(64)], "test": [batch(64)]}


def _jax_loop():
    """_loop_workload on a 4-device mesh with torch's Adagrad rule, from
    ``_jax_init_params("sru")``: (logged rows, final params)."""
    jhp = W.sru_hp(jax_hparams)
    models, jg, jd = _jax_states(jhp)
    cfg = JaxConfig.from_hparams(jhp, **W.LOOP_KW)
    tr = JaxDP(*models, cfg, *_stats("sru"), mesh=jax_mesh(4))
    rows = []

    class Writer:
        def log_value(self, name, value, step):
            rows.append((name, float(value), int(step)))

        def flush(self):
            pass

    jg, jd, _ = jax_loop.train_loop(tr, jg, jd, None, _loop_batches(), jhp,
                                    writer=Writer(), seed=1234, **W.LOOP_KW)
    return rows, jax.tree_util.tree_map(np.array, (jg.params, jd.params))


STEP_CASES = {"vc": ("vc", 16), "sru": ("sru", 8), "vc15": ("vc", 15)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every session: 2 and 4 ranks (steps, MLPG, refusals; on 2 ranks
    also dropout, the loop and the checkpoint handoff, whose resume is a
    fresh 2-rank group), run while this process computes the JAX
    references."""
    tmp = tmp_path_factory.mktemp("dp")
    steps = {k: _step_case(c, B, _jax_init_params(c))
             for k, (c, B) in STEP_CASES.items()}
    rs = np.random.RandomState(0)
    mlpg = {512: rs.randn(2, 512, 15).astype(np.float32),
            2048: rs.randn(1, 2048, 15).astype(np.float32)}
    g0, d0 = _jax_init_params("sru")
    mean, std = _stats("sru")
    loop = dict(g=convert.flax_to_torch(g0), d=convert.flax_to_torch(d0),
                Y_mean=mean, Y_std=std, loaders=_loop_batches())
    ck = str(tmp / "ck")
    os.makedirs(ck)

    def two_ranks():
        first = W.run_session(2, dict(
            steps=steps, mlpg=mlpg, refusals=True,
            dropout={"sru": steps["sru"]}, handoff=steps["vc"], ck=ck,
            resume=False, loop=loop), str(tmp / "two"))
        resumed = W.run_session(
            2, dict(handoff=steps["vc"], ck=ck, resume=True),
            str(tmp / "resume"))
        return first, resumed

    def four_ranks():
        return W.run_session(4, dict(steps=steps, mlpg=mlpg, refusals=True),
                              str(tmp / "four"))

    with ThreadPoolExecutor(2) as pool:
        jobs = [pool.submit(two_ranks), pool.submit(four_ranks)]
        jax_ref = {k: _jax_step(c, B, None)
                   for k, (c, B) in STEP_CASES.items()}
        jax_dp = {k: _jax_step(c, B, jax_mesh(8))
                  for k, (c, B) in STEP_CASES.items()}
        jax_loop_ref = _jax_loop()
        two, resumed = jobs[0].result()
        four = jobs[1].result()
    return dict(ranks={2: two, 4: four}, resumed=resumed, jax_ref=jax_ref,
                jax_dp=jax_dp, mlpg=mlpg, jax_loop=jax_loop_ref, ck=ck)


def _close_scalars(got, ref, rtol, atol, what):
    assert set(got) == set(ref), what
    for k, r in ref.items():
        g = got[k]
        if np.isnan(r) and np.isnan(g):
            continue
        assert np.isclose(g, r, rtol=rtol, atol=atol), (what, k, g, r)


def _close_params(got, ref_tree, what):
    ref = convert.flax_to_torch(ref_tree)
    assert set(got) == set(ref), what
    for k, v in got.items():
        err = float(np.abs(v - ref[k].numpy()).max())
        assert err <= PARAM_ATOL, (what, k, err)


@pytest.mark.parametrize("B,n", [(5, 4), (5, 5), (16, 8), (15, 2), (1, 4)])
def test_pad_batch_to_devices_matches_jax(B, n):
    rs = np.random.RandomState(B * 10 + n)
    x = rs.rand(B, 3, 2).astype(np.float32)
    z = rs.rand(B, 3, 1).astype(np.float32)
    lengths = rs.randint(1, 4, B).astype(np.int32)
    ours, lo = parallel.pad_batch_to_devices([x, z], lengths, n)
    ref, lr = jax_pad([x, z], lengths, n)
    assert lo.dtype == lr.dtype and (lo == lr).all()
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and (a == b).all()
    assert len(lo) % n == 0 and (lo[B:] == 0).all()


@pytest.mark.parametrize("world", [2, 3])
def test_local_rows_tile_the_padded_batch(world):
    x, y, lengths = W.make_batch(7, 4, 2, 3)
    (xp, yp), lp = parallel.pad_batch_to_devices([x, y], lengths, world)
    rows = [parallel.local_rows([x, y], lengths, world, r)
            for r in range(world)]
    assert (np.concatenate([r[0][0] for r in rows]) == xp).all()
    assert (np.concatenate([r[0][1] for r in rows]) == yp).all()
    assert (np.concatenate([r[1] for r in rows]) == lp).all()


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("world", [1, 2, 4])
def test_batch_rows_are_the_global_draws_rows(world, parts, axis):
    """A rank's dropout draw is its rows of the draw the single-device step
    makes on the global batch: rows [r b, (r + 1) b) of each of ``parts``
    blocks of the batch axis (``axis``), whatever the other axes."""
    b, other = 3, (5, 4)
    shape = list(other)
    shape.insert(axis, parts * world * b)
    full = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    local = list(shape)
    local[axis] = parts * b
    for r in range(world):
        gen = batch_view(BatchRows(torch.Generator().manual_seed(1), r,
                                   world), parts=parts, axis=axis)
        got = rand(local, gen, "cpu")
        want = torch.cat([full.narrow(axis, (j * world + r) * b, b)
                          for j in range(parts)], dim=axis)
        assert torch.equal(got, want)
    # a plain generator draws the shape it is asked for
    plain = rand(local, torch.Generator().manual_seed(1), "cpu")
    assert plain.shape == torch.Size(local)


def test_two_ranks_draw_different_masks():
    shape = (4, 8, 16)
    masks = [rand(shape, BatchRows(torch.Generator().manual_seed(0), r, 2),
                  "cpu") < 0.5 for r in range(2)]
    assert not torch.equal(masks[0], masks[1])


def test_workers_hold_nothing_of_jax(runs):
    for world, ranks in runs["ranks"].items():
        assert [r["world"] for r in ranks] == [world] * world
        for r in ranks:
            assert r["jax_modules"] == [], r["jax_modules"][:5]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", ["vc", "sru"])
def test_dp_step_matches_jax(runs, world, case):
    """The port's DP step on ``world`` ranks against the JAX package's
    single-device step and its DP step on 8 devices: every rank's scalars
    and updated parameters."""
    ref_single, ref_dp = runs["jax_ref"][case], runs["jax_dp"][case]
    _close_scalars(ref_dp[1], ref_single[1], SCALAR_RTOL, SCALAR_ATOL,
                   "JAX DP vs JAX single")
    for rank, res in enumerate(runs["ranks"][world]):
        got = res[case]["dp"]
        for ref, what in ((ref_single, "JAX single"), (ref_dp, "JAX DP")):
            _close_scalars(got["out"], ref[1], SCALAR_RTOL, SCALAR_ATOL,
                           f"{what}, rank {rank}")
            _close_params(got["g"], ref[2][0], f"{what} G, rank {rank}")
            _close_params(got["d"], ref[2][1], f"{what} D, rank {rank}")


@pytest.mark.parametrize("world", [2, 4])
def test_dp_step_matches_own_single_process_step(runs, world):
    """The DP step against the port's step on the whole batch, in every
    case (vc15: 15 rows padded to 16 with a zero-length row): scalars and
    the summed gradients to rounding; every rank's parameters the same
    bits."""
    ranks = runs["ranks"][world]
    for case in STEP_CASES:
        single = ranks[0][case]["single"]
        for rank, res in enumerate(ranks):
            dp = res[case]["dp"]
            _close_scalars(dp["out"], single["out"], SELF_RTOL, 0.0,
                           f"{case}, rank {rank}")
            for which in ("grads_g", "grads_d"):
                for k, g in single[which].items():
                    err = float(np.abs(dp[which][k] - g).max())
                    assert err <= GRAD_TOL * float(np.abs(g).max()), \
                        (case, which, k, err)
            for which in ("g", "d"):
                for k, v in ranks[0][case]["dp"][which].items():
                    assert (dp[which][k] == v).all(), (case, rank, k)
    # ragged lengths: the ranks hold different numbers of valid frames
    lengths = _batch("vc", 16)[2].reshape(world, -1).sum(1)
    assert len(set(lengths.tolist())) > 1


@pytest.mark.parametrize("world", [2, 4])
def test_time_sharded_mlpg_matches_jax_and_dense(runs, world):
    windows = jax_hparams.vc.windows
    mesh = jax_mesh(8)
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        None, "data", None))
    for T, u in runs["mlpg"].items():
        ref_sp = np.asarray(jax.jit(lambda m: jax_sp(m, windows, mesh))(
            jax.device_put(u, spec)))
        if T == 512:
            R = jnp.asarray(W.mlpg_matrix(T))
            ref = np.asarray(jax_mlpg(R, jnp.asarray(u)))
        else:
            ref = np.asarray(jax_stencil(jnp.asarray(u), windows))
        for res in runs["ranks"][world]:
            got = res[f"mlpg{T}"]
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() < MLPG_TOL, (T, "dense/stencil")
            assert np.abs(got - ref_sp).max() < MLPG_TOL, (T, "JAX sharded")


@pytest.mark.parametrize("world", [2, 4])
def test_time_sharded_mlpg_refuses_bad_shards(runs, world):
    msgs = runs["ranks"][world][0]["refusals"]
    assert len(msgs) == 2
    for msg, T in zip(msgs, (97 * world + 1, 32 * world)):
        assert msg == (f"time-sharded MLPG needs T divisible by {world} "
                       f"devices with >= 48 frames per shard (got T={T})")


def test_dropout_under_dp_is_the_global_batchs(runs):
    """With dropout on (SRU variational 0.2, discriminator 0.5), every rank
    keeps its rows of the global batch's masks: the 2-rank step equals the
    single-process step on the whole batch to rounding, and differs from
    the step without dropout."""
    ranks = runs["ranks"][2]
    single = ranks[0]["dropout_sru"]["single"]
    for rank, res in enumerate(ranks):
        dp = res["dropout_sru"]["dp"]
        _close_scalars(dp["out"], single["out"], SELF_RTOL, 0.0,
                       f"rank {rank}")
        off = res["sru"]["dp"]["out"]
        assert abs(dp["out"]["mge"] - off["mge"]) > 1e-3 * abs(off["mge"])


def test_checkpoint_handoff(runs):
    """3 DP steps, checkpoints written by rank 0 alone, a fresh 2-rank
    group restores them on every rank and takes step 4: it equals the
    uninterrupted 4-step run."""
    for name in ("Generator", "Discriminator"):
        assert os.path.exists(join(runs["ck"],
                                   f"checkpoint_epoch1_{name}.pth"))
    assert sorted(os.listdir(runs["ck"])) == [
        "checkpoint_epoch1_Discriminator.pth",
        "checkpoint_epoch1_Generator.pth"]
    ref = runs["ranks"][2][0]["uninterrupted"]
    for rank, res in enumerate(runs["resumed"]):
        got = res["step4"]
        _close_scalars(got["out"], ref["out"], SELF_RTOL, 0.0,
                       f"rank {rank}")
        for which in ("g", "d"):
            for k, v in ref[which].items():
                assert (got[which][k] == v).all(), (rank, which, k)


def test_train_loop_two_ranks_matches_jax(runs):
    """_loop_workload (mixed shapes T = 64, 96, 64) through the port's
    train_loop on 2 ranks: both ranks end on the same bits, log the JAX
    package's series on 4 devices (rtol 1e-4, tests/test_torch_train.py's)
    and end on its per-leaf parameter means (test_parallel.py's)."""
    ref_rows, ref_params = runs["jax_loop"]
    r0, r1 = (res["loop"] for res in runs["ranks"][2])
    for which in ("g", "d"):
        for k, v in r0[which].items():
            assert (r1[which][k] == v).all(), (which, k)
    assert [(n, s) for n, _, s in r0["rows"]] == \
        [(n, s) for n, _, s in ref_rows]
    for (name, v, step), (_, r, _) in zip(r0["rows"], ref_rows):
        if name.endswith(("frames_per_sec", "epoch_seconds")):
            continue
        assert abs(v - r) <= 1e-4 * max(abs(r), 1e-3) or \
            (np.isnan(v) and np.isnan(r)), (name, step, v, r)
    for which, tree in zip(("g", "d"), ref_params):
        ref = convert.flax_to_torch(tree)
        for k, v in r0[which].items():
            a, b = float(np.mean(v, dtype=np.float64)), float(
                np.mean(ref[k].numpy(), dtype=np.float64))
            assert np.isclose(a, b, rtol=5e-4, atol=1e-6), (which, k, a, b)


def _vc_cli(tmp_path, tag, extra):
    corpus = str(tmp_path / "corpus")
    hp = ("nepoch=2,batch_size=4,order=19,stream_sizes=[57],"
          "generator_params={'in_dim': None, 'out_dim': None,"
          " 'num_hidden': 1, 'hidden_dim': 16, 'static_dim': 19,"
          " 'dropout': 0.0},"
          "discriminator_params={'in_dim': 19, 'out_dim': 1,"
          " 'num_hidden': 1, 'hidden_dim': 8, 'dropout': 0.0,"
          " 'last_sigmoid': True}")
    log = str(tmp_path / f"log_{tag}")
    return log, subprocess.Popen(
        [sys.executable, "-m", "gantts_tpu_torch.train", join(corpus, "X"),
         join(corpus, "Y"), "--hparams_name=vc", f"--hparams={hp}",
         "--w_d=1.0", f"--checkpoint-dir={tmp_path / ('ck_' + tag)}",
         f"--log-event-path={log}", "--device", "cpu"] + extra,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


def _series(log):
    with open(join(log, "scalars.jsonl")) as f:
        return {(r["tag"], r["step"]): r["value"]
                for r in map(json.loads, f)}


def test_cli_two_cpu_devices_logs_the_single_device_series(tmp_path):
    """tests/test_parallel.py's CLI check on the port: ``--num-devices 2
    --device cpu`` (two spawned gloo workers) logs the series of
    ``--num-devices 1``, and writes the same checkpoint files."""
    from make_synthetic_data import make_vc

    make_vc(str(tmp_path / "corpus"), num=16, order=19)
    log1, p1 = _vc_cli(tmp_path, "single", ["--num-devices", "1"])
    log2, p2 = _vc_cli(tmp_path, "dp", ["--num-devices", "2"])
    out1, out2 = (p.communicate(timeout=600)[0] for p in (p1, p2))
    assert p1.returncode == 0, out1[-3000:]
    assert p2.returncode == 0, out2[-3000:]
    assert "Data-parallel over 2 devices" in out2
    assert "Data-parallel" not in out1
    s1, s2 = _series(log1), _series(log2)
    assert set(s1) == set(s2)
    for key, a in s1.items():
        if "per_sec" in key[0] or "seconds" in key[0]:
            continue
        assert abs(a - s2[key]) <= 2e-4 * max(1.0, abs(a)), (key, a, s2[key])
    assert sorted(os.listdir(tmp_path / "ck_single")) == \
        sorted(os.listdir(tmp_path / "ck_dp"))


def test_dryrun_two_ranks():
    r = subprocess.run(
        [sys.executable, "-m", "gantts_tpu_torch.parallel", "--dryrun", "2"],
        capture_output=True, text=True, cwd=REPO, timeout=600,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("dryrun(2)")]
    assert len(line) == 1, r.stdout[-2000:]
    assert "sp_mlpg_T=512" in line[0]
    for key in ("G=", "D=", "mge=", "mcd="):
        value = float(line[0].split(key)[1].split()[0])
        assert np.isfinite(value)


@pytest.mark.parametrize("requested,device,dp,want", [
    (0, "cuda", True, 1), (1, "cuda", True, 1), (0, "cpu", True, 1),
    (0, "cuda", False, 16)])
def test_steps_per_dispatch_under_dp(requested, device, dp, want):
    assert steps_per_dispatch(requested, device, False, dp) == want


def test_steps_per_dispatch_refused_under_dp():
    with pytest.raises(ValueError, match="one step a dispatch"):
        steps_per_dispatch(16, "cuda", False, True)


def test_num_devices_on_the_cpu():
    assert num_devices(0, "cpu") == 1
    assert num_devices(3, "cpu") == 3
    with pytest.raises(ValueError):
        num_devices(-1, "cpu")
